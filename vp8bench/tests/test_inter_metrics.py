"""CPU tests of the two readers of the decoder's `dec.inter` span
(layer_metrics/dec.inter_ms_per_frame.py, dec.inter_kernel_share.py): on
traces built by hand they read the span's ms per window frame and the
share of window frames whose stages 1-2 were the one kernel launch, and
null on a trace without the span (a program that has none); on a small
traced CPU run of dec1080.api_readback they read a number, the share 0
(the plain torch ops run on the CPU). Importing the trace helper turns
the program's tracing on for the process: the module puts it back as it
found it.

    python -m pytest vp8bench/tests/test_inter_metrics.py -q
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
NAMES = ("dec.inter_ms_per_frame", "dec.inter_kernel_share")


@pytest.fixture(scope="module", autouse=True)
def PT():
    """The helper, imported here; tracing is turned off again at the end
    if it was off, and the helper and the metric modules that read it are
    forgotten (as tests/test_program_trace.py does)."""
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


def _span(name, sid, parent, frame, t0_us, t1_us, **attrs):
    r = trace.Span(name, frame, parent)
    r.id, r.thread = sid, 1
    r.t0, r.t1 = int(t0_us * 1e3), int(t1_us * 1e3)
    r.attrs = attrs
    return r


def _ctx(recs, window):
    return types.SimpleNamespace(tail=None, frames=len(window), log=print,
                                 _program_trace=(recs, window, []))


def _read(name, ctx):
    return loader.module("layer_metrics", name).read(ctx)


def test_declared_for_the_readback_cell():
    for name in NAMES:
        m = next(m for m in SPEC["per_layer"] if m["name"] == name)
        assert m["workloads"] == ["dec1080.api_readback"]
        assert (m["source"], m["layer"], m["moves"]) == (
            "program_span", "residuals, MC", "decode_fps")


def test_read_by_hand():
    """Four window frames, each a root with a `dec.enqueue` child holding
    `dec.inter` (400, 500, 600 and 700 us); three were the kernel launch.
    Frame 5 lies outside the window."""
    recs = []
    for f in range(1, 6):
        base = 10 * (3 * f)
        recs += [_span("dec.dispatch", base, None, f, 0, 2000),
                 _span("dec.enqueue", base + 1, base, f, 100, 1500),
                 _span("dec.inter", base + 2, base + 1, f, 200,
                       200 + 100 * (f + 3), kernel=int(f != 2),
                       inter_mbs=10 * f, split_mbs=f)]
    ctx = _ctx(recs, [1, 2, 3, 4])
    assert _read("dec.inter_ms_per_frame", ctx) == pytest.approx(0.55)
    assert _read("dec.inter_kernel_share", ctx) == pytest.approx(75.0)


def test_null_without_the_span():
    recs = [_span("dec.dispatch", 1, None, 1, 0, 2000),
            _span("dec.enqueue", 2, 1, 1, 100, 1500)]
    ctx = _ctx(recs, [1])
    assert all(_read(name, ctx) is None for name in NAMES)


def test_traced_cpu_run_reads_both():
    logs = []
    r = bench.run(small("dec1080.api_readback"), 2 ** 33 + 7, 1.0, True,
                  time.perf_counter(), device="cpu", log=logs.append)
    assert r["correct"], (r["check"], logs)
    assert r["metrics"]["dec.inter_ms_per_frame"]["value"] > 0
    assert r["metrics"]["dec.inter_kernel_share"]["value"] == 0
