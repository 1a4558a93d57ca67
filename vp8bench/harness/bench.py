"""One run of one cell: set-up, the measured window, the traced tail, the
check against the plain reference, and the result line.

The run's parts, each found by name:
  * `generators/<traffic["generator"]>.py` makes the inputs from the seed;
  * `drivers/<workload["driver"]>.py` builds the program's entry point,
    warms it, and drives one request (one frame) per `step()`;
  * `end_to_end/<metric>.py` reads an end-to-end metric from the window;
  * `layer_metrics/<metric>.py` reads a per-layer metric from the spans
    (its `SPANS`) or the profiled tail (its `ROOFLINE`, a
    `roofline/<kernel>.py`, or the device's busy time);
  * `reference/<config["check"]>.py` judges the outputs.

The window is a closed loop: the next step starts when the last has
returned, for `seconds` seconds; then the driver waits for the card. With
--trace 1 the window runs with the span wrappers on, and then
`workload["trace_frames"]` more steps run under the profiler.
"""
import json
import os
import statistics
import subprocess
import sys
import time

from . import devtrace, loader
from . import spans as S

#: top-level module names that may not be loaded once the window has closed
BANNED = ("jax", "jaxlib", "flax", "libvpx_opencl_tpu")


class Refused(Exception):
    """The run prints no result (no card, an unknown cell, a banned
    import)."""


def banned_modules():
    """The BANNED top-level names present in sys.modules, compared whole:
    `libvpx_opencl_tpu_torch` is not `libvpx_opencl_tpu`."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def resolve(spec, name):
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    mix, workload file and the metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(loader.ROOT, entry["file"])) as f:
        config = json.load(f)
    workload = loader.data("workloads", name)
    if (workload["config"], workload["traffic"]) != (cell["config"],
                                                    cell["traffic"]):
        raise Refused(f"workloads/{name}.json names another config or "
                      "traffic than BENCHMARK.json")
    traffic = loader.data("traffic", cell["traffic"])
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads",
                                                          [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return dict(cell=cell, config=config, traffic=traffic,
                workload=workload, end_to_end=e2e, per_layer=per_layer)


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def measure(drv, seconds):
    """The closed-loop window: steps until `seconds` of running time have
    passed, then the driver's finish (join and synchronize) inside the
    clock. A driver that holds its outputs for the check in a bounded
    store (`due()`, `drain()`) is drained when `due()` says so: its
    finish() runs inside the clock, then the clock stops while drain()
    hands the held outputs to the reference's digest, and starts again.
    The window's seconds are its running time, the pauses left out."""
    lat, errors, failed = [], [], 0
    due = getattr(drv, "due", None)
    paused = 0.0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start - paused < seconds:
        t = time.perf_counter()
        try:
            drv.step()
        except Exception as e:          # a request that failed is counted
            failed += 1
            errors.append(repr(e))
        lat.append(time.perf_counter() - t)
        if due is not None and due():
            try:
                drv.finish()
            except Exception as e:
                failed += 1
                errors.append(repr(e))
            t = time.perf_counter()
            drv.drain()
            paused += time.perf_counter() - t
    try:
        drv.finish()
    except Exception as e:
        failed += 1
        errors.append(repr(e))
    return {"frames": len(lat),
            "seconds": time.perf_counter() - t_start - paused,
            "paused_s": paused, "latencies_s": lat, "failed": failed,
            "errors": errors[:3]}


def _build_program(on_card):
    """Build or load the port's native parts: the g++ entropy runtime and,
    on a card, the nvcc kernels. Returns the seconds of each."""
    from libvpx_opencl_tpu_torch.utils import native
    t = time.perf_counter()
    native.get_lib()
    parts = {"gxx_build_or_load_s": time.perf_counter() - t}
    if on_card:
        from libvpx_opencl_tpu_torch.ops import _cuda
        t = time.perf_counter()
        _cuda.load()
        parts["nvcc_build_or_load_s"] = time.perf_counter() - t
    return parts


class TraceContext:
    """What a per-layer metric's `read` gets: the window's spans and the
    profiled tail."""

    def __init__(self, recorder, frames, tail, captures, peaks, log):
        self.spans = recorder
        self.frames = frames
        self.tail = tail
        self.captures = captures
        self.peaks = peaks
        self.log = log

    def ms_per_frame(self, name):
        """A span's milliseconds per frame of the window, or None if it
        never ran."""
        if not self.spans.calls.get(name) or not self.frames:
            return None
        return self.spans.seconds[name] * 1e3 / self.frames

    def idle_share(self):
        """Percent of the traced window in which no device operation
        ran, or None without device operations."""
        if self.tail is None or not self.tail.device:
            return None
        return 100.0 * (1.0 - self.tail.busy_s / self.tail.window_s)

    def roofline_share(self, kernel):
        """Percent: the least time of the kernel's launches in the tail
        (bytes over the peak bandwidth or 32-bit integer lane instructions
        over the peak rate of the card's INT32 lanes, whichever is longer,
        per launch) over their measured time."""
        mod = loader.module("roofline", kernel)
        records = self.captures.get(kernel, [])
        times = self.tail.kernel_seconds(mod.KERNEL) if self.tail else []
        if not records or not times:
            return None
        if len(records) != len(times):
            self.log(f"roofline {kernel}: {len(records)} launches captured, "
                     f"{len(times)} `{mod.KERNEL}` in the trace: no share")
            return None
        by_bytes = by_instr = least = 0.0
        for rec in records:
            b, n = mod.work(rec)
            tb = b / self.peaks["bytes_per_s"]
            ti = n / self.peaks["int32_lane_instr_per_s"]
            by_bytes += tb
            by_instr += ti
            least += max(tb, ti)
        share = 100.0 * least / sum(times)
        self.log(f"roofline {kernel}: {len(times)} launches, "
                 f"{sum(times) * 1e3:.4f} ms measured, least "
                 f"{least * 1e3:.6f} ms (bytes {by_bytes * 1e3:.6f}, "
                 f"instructions {by_instr * 1e3:.6f}: bound by "
                 f"{'bytes' if by_bytes >= by_instr else 'instructions'}), "
                 f"share {share:.4f}% [{self.peaks['card']}]")
        return share


def _peaks(kind, card):
    """The card's row of roofline/peaks.json (the H100's for another
    card, whose name `card` then carries)."""
    table = loader.data("roofline", "peaks")
    return dict(table.get(kind, table["NVIDIA H100 80GB HBM3"]), card=card)


def run(c, seed, seconds, trace, t0, device="cuda", patch=None,
        log=None):
    """One run of the resolved cell `c` (see `resolve`). Returns the
    result dict, with `check` last. `patch(config)`, for tests and
    controls, changes the program or the config before set-up and returns
    a spans.Patches (or None) that is removed at the end."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    on_card = device == "cuda"
    chips = c["cell"]["chips"]
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < chips):
        raise Refused(f"needs {chips} CUDA card(s); "
                      f"torch.cuda.is_available() = "
                      f"{torch.cuda.is_available()}")
    config = dict(c["config"])
    parts = {"import_s": time.perf_counter() - t0}
    if on_card:
        t = time.perf_counter()
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        parts["cuda_init_s"] = time.perf_counter() - t
    parts.update(_build_program(on_card))
    patches = patch(config) if patch else None
    recorder = S.SpanRecorder()
    window_patches = S.Patches()
    try:
        t = time.perf_counter()
        gen = loader.module("generators", c["traffic"]["generator"])
        inputs = gen.make(config, c["traffic"], seed, device)
        parts["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        drv = loader.module("drivers", c["workload"]["driver"]).Driver(
            config, c["traffic"], inputs, device)
        drv.warm()
        parts["warm_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t0
        print("setup " + json.dumps(dict(parts, setup_s=setup_s)),
              flush=True)

        metric_mods = {m["name"]: loader.module("layer_metrics", m["name"])
                       for m in c["per_layer"]} if trace else {}
        span_specs = [s for mod in metric_mods.values()
                      for s in getattr(mod, "SPANS", [])]
        for s in span_specs:
            window_patches.wrap(s["target"], S.timed_wrapper(s, recorder))
        win = measure(drv, seconds)
        window_patches.remove()
        tail, captures = None, {}
        if trace:
            tail_patches = S.Patches()
            for s in span_specs:
                tail_patches.wrap(s["target"], S.marked_wrapper(s))
            for kernel in sorted({getattr(m, "ROOFLINE", None)
                                  for m in metric_mods.values()} - {None}):
                rl = loader.module("roofline", kernel)
                captures[kernel] = []
                tail_patches.wrap(rl.TARGET, S.capture_wrapper(
                    captures[kernel], rl.capture))
            try:
                tail = devtrace.profile_tail(
                    drv.step, drv.finish, c["workload"]["trace_frames"],
                    on_card)
            finally:
                tail_patches.remove()
            missing = window_patches.missing + tail_patches.missing
            if missing:
                log("spans not found in the program (their metrics read "
                    f"null): {sorted(set(missing))}")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        card = card_line() if on_card else "cpu"
        log(f"card: {card}")
        metrics = {}
        if trace:
            ctx = TraceContext(recorder, win["frames"], tail, captures,
                               _peaks(kind, card), log)
            for m in c["per_layer"]:
                v = metric_mods[m["name"]].read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in c["end_to_end"]:
                v = setup_s if m["name"] == "setup_s" else loader.module(
                    "end_to_end", m["name"]).value(win)
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"window: {win['frames']} frames in {win['seconds']:.3f} s "
            f"(drained with the clock stopped: {win['paused_s']:.3f} s), "
            f"{win['failed']} failed {win['errors']}")
        outputs = drv.outputs()
        drv.close()
        del drv
        failed = win["failed"]
        attempted = win["frames"] + (c["workload"]["trace_frames"]
                                     if trace else 0)
        t = time.perf_counter()
        checks = loader.module("reference", config["check"]).check(
            config, c["traffic"], outputs, seed, log)
        checks.insert(0, {"name": "failed_frames", "value": failed,
                          "limit": 0})
        log(f"check took {time.perf_counter() - t:.1f} s")
    finally:
        window_patches.remove()
        if patches is not None:
            patches.remove()
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": peak}
    if trace and tail is not None:
        dev["busy_s"] = tail.busy_s
        dev["window_s"] = tail.window_s
    result = {"correct": all(k["value"] <= k["limit"] for k in checks),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace and tail is not None:
        result["breakdown"] = tail.breakdown()
    result["check"] = {k["name"]: {"value": k["value"], "limit": k["limit"]}
                       for k in checks}
    return result


def p95(values):
    """The 95th percentile (inclusive method) of a list of numbers."""
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def main(argv, t0):
    """The command line: one run of one cell; the result as the last line
    of standard output, each number compared as the last lines of standard
    error. Exit 2 without a result when the run is refused."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        c = resolve(loader.spec(), args.workload)
        result = run(c, args.seed, args.seconds, bool(args.trace), t0)
        found = banned_modules()
        if found:
            raise Refused(f"modules loaded that the benchmark may not load: "
                          f"{found}")
    except Refused as e:
        print(f"vp8bench: refused: {e}", file=sys.stderr, flush=True)
        return 2
    for name, k in result["check"].items():
        print(f"check {name} = {k['value']} (limit {k['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
