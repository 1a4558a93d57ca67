"""The port's own spans (`libvpx_opencl_tpu_torch/utils/trace.py`) in a
traced run, for the per-layer metrics that read them.

Importing this module turns the port's tracing on. The harness loads the
metric modules, and so this one, only in `--trace 1` runs, after the warm
pass and before the window: the window and the profiled tail are traced,
end-to-end runs are not. The first reader of a run takes the run's records
and empties the program's buffer, so that a later run in the same process
starts from none. A program without a trace module of its own (an older
checkout) makes every reader here return None, so that its metric is left
out of the result line.

Frames: the program gives each decoded or encoded frame an id when its
root span (`dec.decode`, `enc.encode`) opens. The tail's frames are the
last ids recorded, as many as the tail has `step` ranges; the window's
are the `ctx.frames` ids just before them. This holds however many runs
one process has made.

Timeline: the program's clock (`time.perf_counter_ns`) is mapped onto the
profiler's by one offset, the median over the tail's frames of the gap
between a `vp8bench:step` range's start and the start of its frame's
root span; the gaps' spread is logged.
"""
import collections
import statistics

from .devtrace import _merge

try:
    from libvpx_opencl_tpu_torch.utils import trace
except ImportError:             # a program without its own spans
    trace = None
else:
    trace.enable()


def _state(ctx):
    """(records, window frame ids, tail frame ids), read once per run, or
    None without the program's spans."""
    if trace is None:
        return None
    cached = getattr(ctx, "_program_trace", None)
    if cached is None:
        recs = trace.snapshot()
        ids = sorted({r.frame for r in recs if r.frame is not None})
        n_tail = sum(1 for name, _, _ in (ctx.tail.host if ctx.tail else ())
                     if name == "step")
        tail = ids[len(ids) - n_tail:] if n_tail else []
        window = ids[:len(ids) - n_tail][-ctx.frames:] if ctx.frames else []
        cached = ctx._program_trace = (recs, window, tail)
        trace.reset()
    return cached


def window_summary(ctx):
    """`trace.summary` over the window's frames, or None."""
    got = _state(ctx)
    if got is None or not got[1]:
        return None
    cached = getattr(ctx, "_program_summary", None)
    if cached is None:
        cached = ctx._program_summary = trace.summary(got[1], got[0])
        ctx.log(f"program trace: {len(got[1])} window frames, "
                f"{trace.dropped()} records dropped; per frame: " + "; ".join(
                    f"{name} " + " ".join(f"{k[:-10]}={v:.4f}"
                                          for k, v in s.items()
                                          if k != "calls")
                    + f" calls={s['calls']}" for name, s in cached.items()))
    return cached


def per_frame(ctx, name, key="ms_per_frame"):
    """A span's `key` (trace.summary's) per frame of the window, or None
    if the span never ran there."""
    s = window_summary(ctx)
    if s is None or name not in s or key not in s[name]:
        return None
    return s[name][key]


def frame_roots(ctx):
    """[(frame id, root record)] of the tail's frames, in order: each
    frame's earliest span without a parent."""
    recs, _, tail = _state(ctx)
    first = {}
    for r in recs:
        if r.parent is None and r.frame is not None:
            if r.frame not in first or r.t0 < first[r.frame].t0:
                first[r.frame] = r
    return [(f, first[f]) for f in tail if f in first]


def align(ctx):
    """(offset, gaps): microseconds to add to a program time (ns / 1e3)
    to place it on the profiler's timeline, the median of `gaps`, one per
    tail frame. None without the program's spans or a profiled tail."""
    if _state(ctx) is None or ctx.tail is None:
        return None
    cached = getattr(ctx, "_program_align", None)
    if cached is not None:
        return cached
    steps = sorted(s for name, s, _ in ctx.tail.host if name == "step")
    roots = frame_roots(ctx)
    if not steps or len(steps) != len(roots):
        ctx.log(f"program trace: {len(steps)} steps, {len(roots)} frame "
                "roots in the tail: no alignment")
        return None
    gaps = [s - r.t0 / 1e3 for s, (_, r) in zip(steps, roots)]
    offset = statistics.median(gaps)
    q = statistics.quantiles(gaps, n=4) if len(gaps) > 1 else [0, 0, 0]
    ctx.log(f"program trace: offset onto the profiler's clock, median of "
            f"{len(gaps)} step-to-root gaps; spread max-min "
            f"{max(gaps) - min(gaps):.1f} us, quartiles {q[2] - q[0]:.1f} us;"
            " each gap less the median, us, in frame order: "
            + " ".join(f"{g - offset:.1f}" for g in gaps))
    cached = ctx._program_align = (offset, gaps)
    return cached


def device_ms_inside(ctx, name):
    """Card busy time inside the spans `name` of the tail's frames, ms per
    tail frame: the union of the device operations' intervals, clipped to
    each span placed on the profiler's timeline. None without device
    operations, the program's spans or such a span. Logs each span's host
    time, its self time, the card's busy time in it and its CUDA events'
    time, per frame."""
    if ctx.tail is None or not ctx.tail.device:
        return None
    got = align(ctx)
    if got is None:
        return None
    offset = got[0]
    recs, _, tail = _state(ctx)
    frames = set(tail)
    spans = [r for r in recs if r.name == name and r.frame in frames]
    if not spans:
        return None
    busy = _merge((s, e) for _, s, e in ctx.tail.device)
    inside = 0.0
    for r in spans:
        a, b = r.t0 / 1e3 + offset, r.t1 / 1e3 + offset
        inside += sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy
                      if e > a and s < b)
    n = len(tail)
    s = trace.summary(tail, recs).get(name, {})
    ctx.log(f"program trace: {name} over {n} tail frames, ms per frame: "
            f"host {s.get('ms_per_frame', 0):.4f}, self "
            f"{s.get('self_ms_per_frame', 0):.4f}, card busy inside "
            f"{inside / 1e3 / n:.4f}, CUDA events "
            f"{s.get('device_ms_per_frame', float('nan')):.4f}")
    return inside / 1e3 / n


def idle_unnamed_share(ctx):
    """Percent of the tail's device-idle time in which no program span but
    a frame's root is open on any thread, time-weighted; None without
    device operations or the program's spans. Logs the idle time by the
    innermost program span open (the shortest, over every thread)."""
    if ctx.tail is None or not ctx.tail.device:
        return None
    got = align(ctx)
    if got is None:
        return None
    offset = got[0]
    recs = _state(ctx)[0]
    w0, w1 = ctx.tail.window
    busy = _merge((max(s, w0), min(e, w1)) for _, s, e in ctx.tail.device
                  if e > w0 and s < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    spans = []
    for r in recs:
        s, e = r.t0 / 1e3 + offset, r.t1 / 1e3 + offset
        if e > w0 and s < w1:
            spans.append((max(s, w0), min(e, w1), r))
    # sweep the elementary pieces between every edge
    cuts = sorted({x for iv in idle for x in iv}
                  | {x for s, e, _ in spans for x in (s, e)})
    starts = sorted(spans, key=lambda x: x[0])
    by_span = collections.Counter()
    total = unnamed = 0.0
    k = 0
    open_ = []
    i_idle = 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(starts) and starts[k][0] <= a:
            open_.append(starts[k])
            k += 1
        open_ = [x for x in open_ if x[1] > a]
        while i_idle < len(idle) and idle[i_idle][1] <= a:
            i_idle += 1
        if i_idle == len(idle) or idle[i_idle][0] > a:
            continue                    # the device is busy here
        dt = (b - a) / 1e6
        total += dt
        inner = min(open_, key=lambda x: x[2].t1 - x[2].t0, default=None)
        if inner is None:
            label = "outside any program span"
        elif inner[2].parent is None:
            label = inner[2].name + " (self)"
        else:
            label = inner[2].name
        by_span[label] += dt
        if not any(x[2].parent is not None for x in open_):
            unnamed += dt
    if total <= 0:
        return None
    share = 100.0 * unnamed / total
    ctx.log(f"program trace: device idle {total:.4f} s in the tail, "
            f"{unnamed:.4f} s under no stage span ({share:.2f}%); by "
            "innermost program span: " + ", ".join(
                f"{k} {v:.4f} s" for k, v in by_span.most_common()))
    return share
