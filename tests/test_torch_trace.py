"""The port's tracing (libvpx_opencl_tpu_torch/utils/trace.py) on the CPU:
off, it records nothing and changes no output; on, the decoder's and the
encoder's spans nest as PERF.md section 3 lists them, the dispatch
worker's spans carry the entropy thread's frame and parent, `dec.upload`
counts the bytes handed to the device, `enc.host_wait` sits at every read
site reached; `summary` and the bounded buffer by hand; the device spans'
events only while on, closed before the reads.

    python -m pytest tests/test_torch_trace.py -q
"""
import collections
import hashlib
import time

import numpy as np
import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu_torch import api
from libvpx_opencl_tpu_torch.models import torch_decoder as TD
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.models import wavefront as WF
from libvpx_opencl_tpu_torch.ops import me_sad
from libvpx_opencl_tpu_torch.ops import predict as P
from libvpx_opencl_tpu_torch.utils import trace
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.md5 import frame_md5

DEC_FRAMES = 3
ENC_W, ENC_H, ENC_FRAMES = 64, 48, 2
#: sha256 of the ENC_FRAMES payloads of `_encode`, as the port coded them
#: before it had spans
ENC_SHA256 = ("5a64a87bb7756ed0b87cf65e986161c0b9bd61afab6caf8137a37dd8ac"
              "17c136")


def _clip():
    """A seeded 64x48 clip: a moving gradient with noise, a moving square."""
    rng = np.random.default_rng(5)
    row, col = np.mgrid[:ENC_H, :ENC_W]
    out = []
    for t in range(ENC_FRAMES):
        y = (3 * col + 2 * row + 9 * t) % 200 + rng.integers(0, 12, col.shape)
        y[8:24, 8 + 4 * t:24 + 4 * t] = 230
        c = np.full((ENC_H // 2, ENC_W // 2), 128 + 3 * t, np.uint8)
        out.append((y.astype(np.uint8), c, c.copy()))
    return out


def _decode():
    dec = api.CodecDecoder(device="cpu")
    md5s = []
    for payload, _ in list(read_ivf(vector("inter_qcif.ivf")).frames)[
            :DEC_FRAMES]:
        dec.decode(payload)
        md5s += [frame_md5(*planes) for planes in dec.get_frame()]
    return md5s


def _encode():
    enc = api.CodecEncoder(api.EncoderConfig(
        width=ENC_W, height=ENC_H, end_usage="cq", cq_level=24),
        device="cpu")
    payloads = []
    for f in _clip():
        enc.encode(f)
        payloads += [p["data"] for p in enc.get_cx_data()]
    return payloads


def _counting(monkeypatch, owner, attr, counts):
    fn = getattr(owner, attr)

    def wrapper(*a, **k):
        counts[attr] += 1
        return fn(*a, **k)
    monkeypatch.setattr(owner, attr, wrapper)


@pytest.fixture(scope="module")
def traced():
    """One decode and one encode with tracing on: their outputs, records
    and what the sites they pass counted."""
    mp = pytest.MonkeyPatch()
    sent, counts = [], collections.Counter()
    prep = TD.TorchDecoder._prep_arrays

    def keep(self):
        out = prep(self)
        sent.append(out)
        return out
    mp.setattr(TD.TorchDecoder, "_prep_arrays", keep)
    for owner, attr in ((me_sad, "_check"), (WF, "_frame_setup"),
                        (P, "bpred_4x4_all"), (TE.RD, "trellis_mbs")):
        _counting(mp, owner, attr, counts)
    trace.reset()
    trace.enable()
    try:
        md5s = _decode()
        dec_recs = trace.snapshot()
        trace.reset()
        payloads = _encode()
        enc_recs = trace.snapshot()
    finally:
        trace.enable(False)
        trace.reset()
        mp.undo()
    return dict(md5s=md5s, dec=dec_recs, sent=sent, payloads=payloads,
                enc=enc_recs, counts=counts)


def _golden_md5s():
    with open(vector("inter_qcif.ivf.md5")) as f:
        return [line.split()[0] for line in f][:DEC_FRAMES]


@pytest.mark.parametrize("codec", ["decode", "encode"])
def test_off_records_nothing_and_changes_no_output(codec, traced,
                                                   monkeypatch):
    calls = collections.Counter()
    _counting(monkeypatch, time, "thread_time_ns", calls)
    trace.reset()
    out = _decode() if codec == "decode" else _encode()
    assert trace.snapshot() == [] and calls["thread_time_ns"] == 0
    if codec == "decode":
        assert out == _golden_md5s() == traced["md5s"]
    else:
        assert out == traced["payloads"]
        assert hashlib.sha256(b"".join(out)).hexdigest() == ENC_SHA256


def _nested(recs):
    """Every span with a parent on its own thread lies inside it."""
    by_id = {r.id: r for r in recs}
    for r in recs:
        p = by_id.get(r.parent)
        if p is not None and p.thread == r.thread:
            assert p.t0 <= r.t0 <= r.t1 <= p.t1, (r.name, p.name)
            assert p.frame == r.frame


def test_decode_spans(traced):
    recs = traced["dec"]
    _nested(recs)
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r.name].append(r)
    frames = [r.frame for r in by_name["dec.decode"]]
    assert len(frames) == len(set(frames)) == DEC_FRAMES
    assert sorted(r.frame for r in by_name["dec.get_frame"]) == frames
    for name in ("dec.header", "dec.modes", "dec.detokenize", "dec.prep",
                 "dec.submit", "dec.queue_wait", "dec.dispatch",
                 "dec.upload", "dec.enqueue", "dec.join_wait",
                 "dec.device_wait", "dec.readback_copy"):
        assert sorted(r.frame for r in by_name[name]) == frames, name
    roots = {r.id for r in by_name["dec.decode"]} | {
        r.id for r in by_name["dec.get_frame"]}
    assert all((r.parent is None) == (r.id in roots) for r in recs)
    assert all(r.cpu0 is not None for r in by_name["dec.decode"])
    # the worker's spans: another thread, the submit's frame and parent
    submit = {r.frame: r for r in by_name["dec.submit"]}
    for name in ("dec.queue_wait", "dec.dispatch"):
        for r in by_name[name]:
            s = submit[r.frame]
            assert r.parent == s.id and r.thread != s.thread
            assert r.t0 >= s.t0
    # the bytes handed to the device: each frame's arrays, the MC taps
    # with the first frame
    assert len(traced["sent"]) == DEC_FRAMES
    for k, (r, arrs) in enumerate(zip(by_name["dec.upload"],
                                      traced["sent"])):
        table, qcoeff, inter_idx, taps, split = arrs
        want = sum(a.nbytes for a in (table, qcoeff, inter_idx,
                                      *(split or ())))
        assert r.attrs["bytes"] == want + (taps.nbytes if k == 0 else 0)
    s = trace.summary(records=recs)
    assert s["dec.decode"]["calls"] == DEC_FRAMES
    assert s["dec.upload"]["bytes_per_frame"] == pytest.approx(
        sum(r.attrs["bytes"] for r in by_name["dec.upload"]) / DEC_FRAMES)


def test_encode_spans_and_host_waits(traced):
    recs, counts = traced["enc"], traced["counts"]
    _nested(recs)
    by_id = {r.id: r for r in recs}
    names = collections.Counter(r.name for r in recs)
    for name in ("enc.encode", "enc.source", "enc.decision",
                 "enc.encode_mbs", "enc.lf", "enc.pack"):
        assert names[name] == ENC_FRAMES, name
    assert names["enc.mv_modes"] == ENC_FRAMES - 1      # inter frames
    # one enc.host_wait per read site reached: the decision's and the
    # encode wavefront's outputs once per frame, the trellis' inter list
    # once per frame, K5's flags, K3's argument check and the B_PRED
    # table upload once per call
    assert counts["_check"] > 0 and counts["bpred_4x4_all"] > 0
    assert counts["trellis_mbs"] > 0
    waits = [r for r in recs if r.name == "enc.host_wait"]
    assert len(waits) == 3 * ENC_FRAMES + counts["_frame_setup"] + \
        counts["_check"] + counts["bpred_4x4_all"]
    for r in waits:
        assert by_id[r.parent].name in ("enc.decision", "enc.encode_mbs")
    # the decision's self time plus its waits is the decision span
    s = trace.summary(records=recs)
    for r in recs:
        if r.name == "enc.decision":
            kids = [k for k in recs if k.parent == r.id]
            assert kids and all(k.name == "enc.host_wait" for k in kids)
            # CPU: the host clock, up to the reads of the outputs
            last = max(kids, key=lambda k: k.t0)
            assert 0 < r.device_ms * 1e6 <= last.t0 - r.t0 + 1
    dec_waits = sum(r.ms for r in waits
                    if by_id[r.parent].name == "enc.decision")
    assert s["enc.decision"]["self_ms_per_frame"] * ENC_FRAMES + \
        dec_waits == pytest.approx(s["enc.decision"]["ms_per_frame"] *
                                   ENC_FRAMES)


def _rec(name, sid, parent, frame, thread, t0, t1, **attrs):
    r = trace.Span(name, frame, parent)
    r.id, r.thread, r.t0, r.t1 = sid, thread, t0, t1
    r.attrs.update(attrs)
    return r


def test_summary_self_time_by_hand():
    ms = 1_000_000
    recs = [_rec("root", 1, None, 1, 0, 0, 10 * ms),
            _rec("a", 2, 1, 1, 0, 1 * ms, 4 * ms, bytes=100),
            _rec("b", 3, 2, 1, 0, 2 * ms, 3 * ms),
            # on another thread: beside its parent, not inside it
            _rec("w", 4, 2, 1, 7, 3 * ms, 12 * ms, bytes=50),
            _rec("root", 5, None, 2, 0, 20 * ms, 24 * ms),
            _rec("a", 6, 5, 2, 0, 21 * ms, 22 * ms),
            _rec("x", 7, None, None, 0, 0, 100 * ms)]
    s = trace.summary(records=recs)
    assert "x" not in s
    assert s["root"] == {"calls": 2, "ms_per_frame": 7.0,
                         "self_ms_per_frame": 5.0}
    assert s["a"] == {"calls": 2, "ms_per_frame": 2.0,
                      "self_ms_per_frame": 1.5, "bytes_per_frame": 50.0}
    assert s["w"]["self_ms_per_frame"] == 4.5
    only1 = trace.summary([1], recs)
    assert only1["root"]["self_ms_per_frame"] == 7.0
    assert only1["a"]["bytes_per_frame"] == 100


def test_buffer_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=4))
    monkeypatch.setattr(trace, "_dropped", 0)
    trace.enable()
    try:
        for k in range(6):
            with trace.span(f"s{k}", new_frame=True):
                pass
    finally:
        trace.enable(False)
    assert trace.dropped() == 2
    assert [r.name for r in trace.snapshot()] == ["s2", "s3", "s4", "s5"]


class _FakeEvent:
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made.append(self)
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


@pytest.mark.parametrize("on", [False, True])
def test_device_span_events_only_when_on(on, monkeypatch):
    """A device span on a CUDA device records two timing events, resolved
    by snapshot(); off, it makes none and reads no clock."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    calls = collections.Counter()
    _counting(monkeypatch, time, "thread_time_ns", calls)
    _counting(monkeypatch, time, "perf_counter_ns", calls)
    _FakeEvent.made = []
    trace.reset()
    trace.enable(on)
    try:
        with trace.span("d", new_frame=True, cpu=True,
                        device=torch.device("cuda")) as sp:
            sp.device_end()
            with trace.host_wait():
                pass
    finally:
        trace.enable(False)
    recs = trace.snapshot()
    trace.reset()
    if not on:
        assert recs == [] and _FakeEvent.made == [] and not calls
        return
    assert len(_FakeEvent.made) == 2 and calls["thread_time_ns"] == 2
    d, w = sorted(recs, key=lambda r: r.t0)
    assert d.name == "d" and w.name == "d.host_wait"
    assert d.device_ms is not None and w.parent == d.id
    # closed before the wait
    assert _FakeEvent.made[1].t <= w.t0

