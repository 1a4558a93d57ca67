"""Frames encoded, their packets returned by get_cx_data(), in the window
over the window's seconds."""


def value(window):
    return window["frames"] / window["seconds"]
