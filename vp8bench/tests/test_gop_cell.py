"""CPU tests of the four-stream cell `streams4.gop_decode` (driver
`drivers/decode_gop.py`): at the small size of `small()` (the four
streams on tests/data/inter_qcif.ivf, offsets modulo its 10 frames) a run
through `bench.run` is correct with every frame of every stream compared;
a traced run gives each `gop.*` metric a value; on "cuda" the driver
refuses fewer cards than streams before it builds anything.

    python -m pytest vp8bench/tests/test_gop_cell.py -q
"""
import re
import time

import pytest
import torch

from vp8bench.harness import bench, loader
from vp8bench.tests.test_vp8bench_harness import SPEC, small

CELL = "streams4.gop_decode"


def _run(trace):
    logs = []
    r = bench.run(small(CELL), 2 ** 33 + 5, 1.0, trace, time.perf_counter(),
                  device="cpu", log=logs.append)
    return r, logs


def test_small_run_compares_every_stream():
    r, logs = _run(False)
    assert r["correct"], (r["check"], logs)
    assert r["failed"] == 0 and r["attempted"] > 0
    compared = [int(m.group(1)) for m in (re.match(r"md5: (\d+) frames",
                                                   line) for line in logs)
                if m]
    streams = bench.resolve(SPEC, CELL)["config"]["streams"]
    assert compared == [streams * r["attempted"]]


def test_traced_small_run_reads_every_gop_metric():
    r, logs = _run(True)
    assert r["correct"], (r["check"], logs)
    names = {m["name"] for m in SPEC["per_layer"]
             if CELL in m["workloads"] and m["source"] == "program_span"}
    assert {n for n in names if n.startswith("gop.")} == {
        "gop.set_wait_ms_per_set", "gop.stream_ms_per_frame",
        "gop.entropy_offcpu_ms_per_frame"}
    assert names <= set(r["metrics"]), (r["metrics"], logs)
    assert all(r["metrics"][n]["value"] >= 0 for n in names)
    # no device on the CPU: no idle share
    assert "device_idle_share.gop4" not in r["metrics"]


def test_driver_refuses_fewer_cards_than_streams(monkeypatch):
    c = bench.resolve(SPEC, CELL)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    drv = loader.module("drivers", c["workload"]["driver"])
    with pytest.raises(RuntimeError, match="4 streams need 4 cards"):
        drv.Driver(c["config"], c["traffic"], {"payloads": []}, "cuda")
