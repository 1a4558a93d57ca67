"""Frames decoded in the window over the window's seconds (the clock
stopped once the card has finished every frame)."""


def value(window):
    return window["frames"] / window["seconds"]
