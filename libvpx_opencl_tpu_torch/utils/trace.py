"""The port's tracing: spans at the layer boundaries of both codecs.

Off by default. `enable()` turns it on for the whole process; while it is
off every span site costs one flag test and records nothing (no clock
read, no CUDA event). While it is on, each span appends one record to a
bounded in-memory buffer (`CAPACITY` records; when full the oldest is
dropped and counted in `dropped()`).

A record holds the span's name, its start and end on
`time.perf_counter_ns`, its thread, its frame id, its parent span and
optional integer attributes (`attrs`, such as bytes). Parents come from a
per-thread stack of open spans. Work handed to another thread carries its
frame id and parent explicitly (`handoff` on the sending thread,
`picked_up` on the receiving one). A root opened with `new_frame=True`
under a span that was given its frame (a handed-over frame, as the
stream-set decoder's `gop.stream` is) takes that frame's id instead of a
new one: the streams of one set share the set's id. A span opened with
`cpu=True` also reads `time.thread_time_ns` at both ends. A span opened
with `device=` a CUDA device records a timing event on the current stream
when it opens and when it closes, or earlier at `device_end()` (after the
enqueue, before the reads that wait for the work), resolved into
`device_ms` by `snapshot()` once the work has finished (the caller's own
synchronisation; tracing adds none); on the CPU the work is synchronous
and `device_ms` is the host clock's from the open to that point.

    from libvpx_opencl_tpu_torch.utils import trace
    trace.enable()
    ...                         # decode or encode
    torch.cuda.synchronize()
    for name, s in trace.summary().items():
        print(name, s)          # ms per frame, self ms per frame, ...

The spans and the metrics that read them are listed in PERF.md, section 3.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

#: records kept; the oldest are dropped beyond it
CAPACITY = 1 << 20

_on = False
_lock = threading.Lock()
_records = collections.deque(maxlen=CAPACITY)
_dropped = 0
_local = threading.local()
_span_ids = itertools.count(1)
_frame_ids = itertools.count(1)


def enable(on=True):
    """Turn tracing on (or off, with on=False) for the process."""
    global _on
    _on = bool(on)


def reset():
    """Forget every record and the drop count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def dropped():
    """Records dropped because the buffer was full."""
    return _dropped


def _keep(rec):
    global _dropped
    with _lock:
        if len(_records) == CAPACITY:
            _dropped += 1
        _records.append(rec)


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One span: a context manager while open, a record once closed.
    Times are perf_counter_ns (t0, t1) and thread_time_ns (cpu0, cpu1,
    None without cpu=True); `device_ms` is None until resolved."""

    __slots__ = ("name", "id", "parent", "frame", "thread", "t0", "t1",
                 "cpu0", "cpu1", "attrs", "device_ms", "_cpu", "_new",
                 "_carried", "_device", "_events")

    def __init__(self, name, frame=None, parent=None, cpu=False,
                 new_frame=False, device=None):
        self.name = name
        self.frame = frame
        self.parent = parent
        self._cpu = cpu
        self._new = new_frame
        # a frame given, not found: new-frame roots inside take it
        self._carried = frame is not None
        self._device = device
        self._events = None
        self.cpu0 = self.cpu1 = self.device_ms = None
        self.attrs = {}

    def __enter__(self):
        st = _stack()
        top = st[-1] if st else None
        self.id = next(_span_ids)
        self.thread = threading.get_ident()
        if self.parent is None and top is not None:
            self.parent = top.id
        if top is not None and top._carried:
            self._carried = True
            if self._new:
                self.frame = top.frame
        if self._new and not self._carried:
            self.frame = next(_frame_ids)
        elif self.frame is None and top is not None:
            self.frame = top.frame
        st.append(self)
        if self._device is not None and self._device.type == "cuda":
            import torch
            stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
        if self._cpu:
            self.cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def device_end(self, now=None):
        """Close the device span here: record its closing event (on the
        CPU, read the host clock). Called after the span's work has been
        enqueued and before the reads that wait for it; otherwise the span
        closes it."""
        if self._device is None:
            return
        if self._events is not None:
            import torch
            self._events[1].record(torch.cuda.current_stream(self._device))
        else:
            now = time.perf_counter_ns() if now is None else now
            self.device_ms = (now - self.t0) / 1e6
        self._device = None

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self._cpu:
            self.cpu1 = time.thread_time_ns()
        self.device_end(self.t1)
        st = _stack()
        # spans left open above this one by a raise are closed with it
        while st:
            if st.pop() is self:
                break
        _keep(self)
        return False

    @property
    def ms(self):
        return (self.t1 - self.t0) / 1e6

    @property
    def cpu_ms(self):
        return None if self.cpu0 is None else (self.cpu1 - self.cpu0) / 1e6

    def _resolve(self):
        ev0, ev1 = self._events
        if ev1.query():
            self.device_ms = ev0.elapsed_time(ev1)
            self._events = None


class _Off:
    """What a span site gets while tracing is off: does nothing, is
    false."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def device_end(self, now=None):
        pass


_OFF = _Off()


def span(name, frame=None, parent=None, cpu=False, new_frame=False,
         device=None):
    """A span named `name` around a `with` block. The frame and parent
    default to the thread's innermost open span; new_frame=True gives the
    span the next frame id (the root of a decoded or encoded frame), or,
    under a span that was given its frame, that frame's id.
    cpu=True adds the thread's CPU time; device= the torch.device whose
    enqueued work the span brackets. The span is false while tracing is
    off, so that attributes are only computed when they are recorded:
    `if sp: sp.attrs["bytes"] = ...`."""
    if not _on:
        return _OFF
    return Span(name, frame, parent, cpu, new_frame, device)


def host_wait():
    """A span around a host read (or blocking copy) that waits for the
    card: `<codec>.host_wait`, the codec the prefix of the thread's
    outermost open span (`enc.host_wait` inside `enc.encode`)."""
    if not _on:
        return _OFF
    st = _stack()
    codec = st[0].name.partition(".")[0] + "." if st else ""
    return Span(codec + "host_wait")


def frame():
    """The frame id of the thread's innermost open span, or None."""
    if not _on:
        return None
    st = _stack()
    return st[-1].frame if st else None


def handoff():
    """What a thread passes with work it hands to another thread: (frame,
    parent span id, time handed over), or None while tracing is off."""
    if not _on:
        return None
    st = _stack()
    top = st[-1] if st else None
    return (top.frame if top else None, top.id if top else None,
            time.perf_counter_ns())


def picked_up(name, origin):
    """On the thread that received `origin` (from `handoff`): record the
    span `name` from the hand-over to now, the time the work waited to be
    picked up. Returns (frame, parent) for the spans the work opens."""
    if origin is None:
        return None, None
    frame_id, parent, t_handed = origin
    _record(name, frame_id, parent, t_handed, time.perf_counter_ns())
    return frame_id, parent


def interval(name, t0, t1):
    """Record the span `name` from t0 to t1 (perf_counter_ns), measured
    elsewhere, on this thread under its innermost open span."""
    if not _on:
        return
    st = _stack()
    top = st[-1] if st else None
    _record(name, top.frame if top else None, top.id if top else None, t0,
            t1)


def _record(name, frame_id, parent, t0, t1):
    rec = Span(name, frame_id, parent)
    rec.id = next(_span_ids)
    rec.thread = threading.get_ident()
    rec.t0, rec.t1 = t0, t1
    _keep(rec)


def snapshot():
    """Every record kept, oldest first, with the device times of finished
    device spans resolved."""
    with _lock:
        recs = list(_records)
    for r in recs:
        if r._events is not None:
            r._resolve()
    return recs


def summary(frames=None, records=None):
    """Per span name over the frames `frames` (ids; default every frame
    recorded): {"calls", "ms_per_frame", "self_ms_per_frame"} and, where
    recorded, "cpu_ms_per_frame", "device_ms_per_frame" and
    "<attribute>_per_frame". A span's self time is its length less its
    children's on its own thread (a span on another thread that names it
    as parent ran beside it, not inside it)."""
    recs = snapshot() if records is None else records
    if frames is None:
        frames = {r.frame for r in recs if r.frame is not None}
    frames = set(frames)
    if not frames:
        return {}
    sel = [r for r in recs if r.frame in frames]
    thread_of = {r.id: r.thread for r in sel}
    child_ns = collections.Counter()
    for r in sel:
        if r.parent is not None and thread_of.get(r.parent) == r.thread:
            child_ns[r.parent] += r.t1 - r.t0
    sums = {}
    for r in sel:
        s = sums.setdefault(r.name, collections.Counter())
        s["calls"] += 1
        s["ms"] += r.ms
        s["self_ms"] += (r.t1 - r.t0 - child_ns[r.id]) / 1e6
        if r.cpu0 is not None:
            s["cpu_ms"] += r.cpu_ms
        if r.device_ms is not None:
            s["device_ms"] += r.device_ms
        for k, v in r.attrs.items():
            s[k] += v
    n = len(frames)
    return {name: dict({"calls": s.pop("calls")},
                       **{k + "_per_frame": v / n for k, v in s.items()})
            for name, s in sums.items()}
