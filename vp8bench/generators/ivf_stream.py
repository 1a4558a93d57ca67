"""Inputs of a decode cell: the compressed frames of the configuration's
IVF stream (`config["stream"]`, relative to vp8bench/), looped by the
driver. The stream is fixed: the seed changes nothing in it."""
import os

from vp8bench.harness.ivf import read_ivf

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make(config, traffic, seed, device):
    w, h, payloads = read_ivf(os.path.join(HERE, config["stream"]))
    return {"width": w, "height": h, "payloads": payloads}
