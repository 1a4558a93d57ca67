"""CPU tests of harness/program_trace.py, the reader of the port's own
spans: on a small traced run of each cell every per-layer metric read
from the program's spans reads a number, and the helper's offset places
each tail frame's root span inside its `vp8bench:step` range under the
CPU profiler; the device-idle share no stage span names and the card's
busy time inside a span, on tails built by hand. Importing the helper
turns the program's tracing on for the process: the module puts it back
as it found it.

    python -m pytest vp8bench/tests/test_program_trace.py -q
"""
import importlib
import os
import sys
import time
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from vp8bench import harness  # noqa: E402
from vp8bench.harness import bench, loader  # noqa: E402
from vp8bench.tests.test_vp8bench_harness import SPEC, small  # noqa: E402
from libvpx_opencl_tpu_torch.utils import trace  # noqa: E402

PT_NAME = "vp8bench.harness.program_trace"


@pytest.fixture(scope="module", autouse=True)
def PT():
    """The helper, imported here (so that collecting this file turns
    nothing on). If tracing was off before, it is turned off again at the
    end and the helper and the metric modules that read it are forgotten,
    so that the next traced run imports them and turns it on again."""
    was_on = PT_NAME in sys.modules and trace._on
    pt = importlib.import_module(PT_NAME)
    yield pt
    if not was_on:
        trace.enable(False)
        trace.reset()
        for key, mod in list(loader._modules.items()):
            if getattr(mod, "PT", None) is pt:
                del loader._modules[key]
        sys.modules.pop(PT_NAME, None)
        if getattr(harness, "program_trace", None) is pt:
            del harness.program_trace

CELLS = ["dec1080.api_readback", "enc1080.good.motion"]


def _program_metrics(cell):
    return [m for m in SPEC["per_layer"] if cell in m["workloads"]
            and "program_trace" in open(loader.path(
                "layer_metrics", m["name"], ".py")).read()]


@pytest.fixture(scope="module", params=CELLS)
def traced_run(request, PT):
    """A small traced run of the cell on the CPU, with the TraceContext
    the metrics read; the program's buffer, emptied by the run's first
    reader, holds no span of the run after it."""
    cell = request.param
    seen = []
    mods = [loader.module("layer_metrics", m["name"])
            for m in _program_metrics(cell)]
    mp = pytest.MonkeyPatch()
    for mod in mods:
        read = mod.read

        def keep(ctx, read=read):
            seen.append(ctx)
            return read(ctx)
        mp.setattr(mod, "read", keep)
    logs = []
    try:
        r = bench.run(small(cell), 2 ** 33 + 11, 1.0, True,
                      time.perf_counter(), device="cpu", log=logs.append)
    finally:
        mp.undo()
    assert trace.snapshot() == []
    return cell, r, seen[0], logs


def test_program_span_metrics_read_numbers(traced_run):
    cell, r, _, logs = traced_run
    assert r["correct"], (r["check"], logs)
    names = [m["name"] for m in _program_metrics(cell)]
    spans = [n for n in names if next(
        m for m in SPEC["per_layer"] if m["name"] == n)["source"] ==
        "program_span"]
    assert len(spans) == {"dec1080.api_readback": 6,
                          "enc1080.good.motion": 2}[cell]
    for n in spans:
        v = r["metrics"][n]["value"]
        assert isinstance(v, float) and v >= 0, n
    # no device on the CPU: the metrics read from the profiled tail's
    # device operations read null
    assert len(names) - len(spans) == {"dec1080.api_readback": 1,
                                       "enc1080.good.motion": 2}[cell]
    assert not [n for n in names if n in r["metrics"] and n not in spans]
    if cell.startswith("dec"):
        assert r["metrics"]["dec.upload_bytes_per_frame"]["value"] > 0
    else:
        assert r["metrics"]["enc.host_wait_ms_per_frame"]["value"] > 0


def test_roots_fall_inside_their_steps(traced_run, PT):
    """Each tail frame's root span, moved by the helper's offset, lies in
    its step range, to within the gaps' spread (max - min), which is small
    against a step."""
    _, _, ctx, _ = traced_run
    offset, gaps = PT.align(ctx)
    steps = sorted((s, e) for name, s, e in ctx.tail.host if name == "step")
    roots = PT.frame_roots(ctx)
    assert len(steps) == len(roots) == 2 == len(gaps)
    spread = max(gaps) - min(gaps)
    assert spread < 0.1 * min(e - s for s, e in steps)
    for (s, e), (_, r) in zip(steps, roots):
        assert s - spread <= r.t0 / 1e3 + offset
        assert r.t1 / 1e3 + offset <= e + spread
    frames = [f for f, _ in roots]
    assert frames == sorted(frames)
    window = PT._state(ctx)[1]
    assert len(window) == ctx.frames and window[-1] < frames[0]


def _span(name, sid, parent, thread, t0_us, t1_us, frame=1):
    r = trace.Span(name, frame, parent)
    r.id, r.thread = sid, thread
    r.t0, r.t1 = int(t0_us * 1e3), int(t1_us * 1e3)
    return r


def test_idle_unnamed_share_by_hand(PT):
    # a tail of 1000 us, the device busy 100-200 and 500-600: idle 800 us
    tail = types.SimpleNamespace(
        window=(0.0, 1000.0), host=[("step", 0.0, 1000.0)],
        device=[("k", 100.0, 200.0), ("k", 500.0, 600.0)])
    recs = [_span("root", 1, None, 0, 0, 900),
            _span("a", 2, 1, 0, 50, 250),       # names idle 50-100, 200-250
            _span("w", 3, 2, 7, 300, 400)]      # another thread: 300-400
    logs = []
    ctx = types.SimpleNamespace(tail=tail, frames=0, log=logs.append,
                                _program_trace=(recs, [], [1]))
    assert PT.align(ctx)[0] == 0
    assert PT.idle_unnamed_share(ctx) == pytest.approx(75.0)
    line = logs[-1]
    assert "root (self) 0.0005 s" in line and "a 0.0001 s" in line
    assert "outside any program span 0.0001 s" in line


def test_busy_inside_by_hand(PT):
    """Three tail frames, each root 10 us after its step starts. The card
    is busy 40 us inside the first `d` span, 60 us inside the second (two
    operations that overlap count once) and not inside the third."""
    tail = types.SimpleNamespace(
        window=(0.0, 3000.0),
        host=[("step", 0.0, 900.0), ("step", 1000.0, 1900.0),
              ("step", 2000.0, 2900.0)],
        device=[("k", 150.0, 190.0), ("k", 1400.0, 1420.0),
                ("k", 1410.0, 1460.0), ("k", 1700.0, 1800.0)])
    recs = [_span("root", 1, None, 0, 10, 800, frame=1),
            _span("d", 2, 1, 0, 100, 200, frame=1),
            _span("root", 3, None, 0, 1010, 1800, frame=2),
            _span("d", 4, 3, 0, 1400, 1500, frame=2),
            _span("root", 5, None, 0, 2010, 2800, frame=3),
            _span("d", 6, 5, 0, 2100, 2200, frame=3)]
    logs = []
    ctx = types.SimpleNamespace(tail=tail, frames=0, log=logs.append,
                                _program_trace=(recs, [], [1, 2, 3]))
    assert PT.align(ctx)[0] == pytest.approx(-10.0)
    # placed on the profiler's clock: d spans 90-190, 1390-1490, 2090-2190
    assert PT.device_ms_inside(ctx, "d") == pytest.approx(
        (40 + 60) / 1e3 / 3)
    assert "card busy inside 0.0333" in logs[-1]
    assert PT.device_ms_inside(ctx, "nothing") is None
