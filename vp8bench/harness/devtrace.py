"""The profiled tail of a traced run, and what is read from it.

`profile_tail` runs a fixed number of steps of the cell's `drivers/`
module under `torch.profiler` (CPU and CUDA activity) inside one range,
`vp8bench:tail`, which is the traced window. `Tail` keeps every device
operation (kernels, copies, fills) as (name, start, end) in microseconds
and the benchmark's own host ranges (`vp8bench:<span>`).

Busy time is the union of the device operations' intervals inside the
window, so operations that overlap on two streams count once.
"""
import collections

_PREFIX = "vp8bench:"


def profile_tail(step, finish, n_steps, on_card):
    """Run `step` n_steps times, then `finish` (which waits for the card),
    under the profiler; returns a Tail."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(_PREFIX + "tail"):
            for _ in range(n_steps):
                with record_function(_PREFIX + "step"):
                    step()
            finish()
    return Tail(prof.events())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Tail:
    def __init__(self, events):
        from torch.autograd import DeviceType
        self.device, self.host, self.window = [], [], None
        for ev in events:
            s, e = ev.time_range.start, ev.time_range.end
            if ev.device_type == DeviceType.CUDA:
                # the profiler mirrors the benchmark's own ranges onto the
                # device's timeline (user annotations): not operations
                if not ev.name.startswith(_PREFIX):
                    self.device.append((ev.name, s, e))
            elif ev.name == _PREFIX + "tail":
                self.window = (s, e)
            elif ev.name.startswith(_PREFIX):
                self.host.append((ev.name[len(_PREFIX):], s, e))
        if self.window is None:
            raise RuntimeError("the profiler recorded no vp8bench:tail range")
        w0, w1 = self.window
        self._busy = _merge((max(s, w0), min(e, w1))
                            for _, s, e in self.device if e > w0 and s < w1)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self):
        return sum(e - s for s, e in self._busy) / 1e6

    def kernel_seconds(self, kernel):
        """Durations (s) of the device operations whose name holds
        `kernel`, in the order they ran."""
        return [(e - s) / 1e6 for name, s, e in sorted(
            self.device, key=lambda x: x[1]) if kernel in name]

    def _host_at(self, t):
        """The innermost benchmark range open on the host at time t."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "outside any span"

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle time
        between device operations by the host span open in its middle."""
        ops = collections.Counter()
        for name, s, e in self.device:
            ops[name[:160]] += (e - s) / 1e6
        gaps = collections.Counter()
        w0, w1 = self.window
        edges = [w0] + [x for iv in self._busy for x in iv] + [w1]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                gaps[self._host_at((s + e) / 2)] += (e - s) / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}
