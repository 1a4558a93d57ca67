#!/usr/bin/env python3
"""What the port's tracing costs when on, and its spans without the
benchmark's wrappers, on one cell of BENCHMARK.json.

    python3 tools/trace_cost.py --workload <cell> --seed <n> --seconds <s> [--chunk <s>]

from the root of a checkout, on a CUDA card (`--device cpu` runs it on the
CPU). Sets the cell up as `vp8bench/run.py` does (inputs from the seed,
the cell's `drivers/` module, its warm pass), then runs closed-loop chunks
of `--chunk` seconds with the port's tracing
(`libvpx_opencl_tpu_torch/utils/trace.py`) off and on in turns,
off-on-on-off, for `--seconds` in all. Each chunk is timed as the
benchmark times its window (`harness/bench.py:measure`: the step loop's
finish inside the clock, its drain outside). Chunks a few seconds apart
in one process pair each traced chunk with an untraced one on a host of
the same speed; the host's speed moves within a call (PERF.md, section 2), and
the ABBA order cancels a steady drift. The benchmark's span wrappers are
not installed, so nothing adds a synchronize().

Prints each chunk's frames/s on standard error, then one JSON line: the
chunks, the ratio on/off of each pair, their median and quartiles, and
`trace.summary` over the traced chunks' frames (ms per frame by span).
"""
import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

# as vp8bench/run.py: few math-library threads, set before torch loads
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vp8bench.harness import bench, loader  # noqa: E402
from libvpx_opencl_tpu_torch.utils import trace  # noqa: E402

#: tracing on or off in each chunk, repeated
ORDER = (False, True, True, False)


def run(c, seed, seconds, chunk, device="cuda", log=None):
    """Chunks of the resolved cell `c` (bench.resolve) with tracing off
    and on in turns; returns the result dict."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    on_card = device == "cuda"
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    bench._build_program(on_card)
    config = dict(c["config"])
    gen = loader.module("generators", c["traffic"]["generator"])
    inputs = gen.make(config, c["traffic"], seed, device)
    drv = loader.module("drivers", c["workload"]["driver"]).Driver(
        config, c["traffic"], inputs, device)
    drv.warm()
    card = bench.card_line() if on_card else "cpu"
    log(f"card: {card}; set-up {time.perf_counter() - T0:.3f} s")
    trace.reset()
    chunks = []
    n = max(len(ORDER), round(seconds / chunk / len(ORDER)) * len(ORDER))
    try:
        for k in range(n):
            on = ORDER[k % len(ORDER)]
            trace.enable(on)
            try:
                win = bench.measure(drv, chunk)
            finally:
                trace.enable(False)
            fps = win["frames"] / win["seconds"]
            chunks.append({"on": on, "frames": win["frames"],
                           "seconds": win["seconds"], "fps": fps,
                           "failed": win["failed"]})
            log(f"chunk {k}: tracing {'on ' if on else 'off'} "
                f"{win['frames']} frames in {win['seconds']:.3f} s, "
                f"{fps:.4f} frames/s, {win['failed']} failed")
        records = trace.snapshot()
    finally:
        drv.close()
    ratios = []
    for a, b in zip(chunks[0::2], chunks[1::2]):
        on_, off = (a, b) if a["on"] else (b, a)
        ratios.append(on_["fps"] / off["fps"])
    q = statistics.quantiles(ratios, n=4) if len(ratios) > 1 else ratios * 3
    summary = trace.summary(records=records)
    trace.reset()
    return {"card": card, "chunks": chunks, "ratios_on_off": ratios,
            "median_ratio": statistics.median(ratios),
            "quartiles": [q[0], q[2]],
            "failed": sum(ch["failed"] for ch in chunks),
            "records": len(records), "dropped": trace.dropped(),
            "summary": summary}


def main(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--chunk", type=float, default=4.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    c = bench.resolve(loader.spec(), args.workload)
    r = run(c, args.seed, args.seconds, args.chunk, args.device)
    print(json.dumps(dict(r, workload=args.workload, seed=args.seed)),
          flush=True)
    return 1 if r["failed"] else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
