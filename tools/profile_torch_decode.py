#!/usr/bin/env python3
"""Where the time goes in the port's 1080p decode (PyTorch/CUDA).

Run from the repository root on a machine with a CUDA card:

    python3 tools/profile_torch_decode.py [--stream tests/vectors/bench_1080p.ivf]

Decodes the stream once to warm up, then:
  * host split: wall time of the whole decode; then, in a second decode
    with timers, the time spent in the entropy thread's stages (mode/MV
    decode, detokenize, array prep) and in the dispatch worker (upload +
    enqueue), per frame;
  * device: one decode under torch.profiler (CPU + CUDA activity); device
    time per kernel name, the total busy time and the idle share of the
    decode's wall time.
Prints the card (nvidia-smi name, power limit) and one JSON line. It
imports nothing of JAX or of the JAX package.
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.utils.ivf import read_ivf

    ap = argparse.ArgumentParser()
    ap.add_argument("--stream", default=os.path.join(
        HERE, "tests", "vectors", "bench_1080p.ivf"))
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    frames = [p for p, _ in read_ivf(args.stream).frames]

    host = collections.Counter()
    patched = []

    def timed(cls, name, key):
        fn = getattr(cls, name)
        patched.append((cls, name, cls.__dict__.get(name)))

        def wrapper(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                host[key] += time.perf_counter() - t0
        setattr(cls, name, wrapper)

    def unpatch():
        for cls, name, orig in reversed(patched):
            if orig is None:
                delattr(cls, name)
            else:
                setattr(cls, name, orig)

    def decode():
        dec = TD.TorchDecoder(device="cuda")
        t0 = time.perf_counter()
        for payload in frames:
            dec.decode_frame_core(payload)
        dec._sync()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    decode()
    wall = decode()
    # per-stage host time, each thread's own wall clock (the entropy
    # thread and the dispatch worker run concurrently and share the GIL)
    timed(TD.TorchDecoder, "_decode_modes", "modes_mv")
    timed(TD.TorchDecoder, "_detokenize_all", "detokenize")
    timed(TD.TorchDecoder, "_prep_arrays", "prep_arrays")
    timed(TD.TorchDecoder, "_worker_dispatch", "dispatch_worker")
    timed(TD.TorchDecoder, "decode_frame_core", "entropy_thread_total")
    timed_wall = decode()
    unpatch()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = decode()
    dev = collections.Counter()
    calls = collections.Counter()
    # kernel events only: an operator's row repeats its kernels' time
    from torch.autograd import DeviceType
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t > 0 and ev.device_type == DeviceType.CUDA:
            dev[ev.key] += t / 1e3          # us -> ms
            calls[ev.key] += ev.count
    busy = sum(dev.values())
    n = len(frames)
    out = {
        "card": card, "stream": os.path.basename(args.stream),
        "frames": n, "fps": n / wall, "wall_ms_per_frame": wall * 1e3 / n,
        "timed_wall_ms_per_frame": timed_wall * 1e3 / n,
        "host_ms_per_frame": {k: v * 1e3 / n for k, v in host.items()},
        "profiled_wall_ms_per_frame": prof_wall * 1e3 / n,
        "device_busy_ms_per_frame": busy / n,
        "device_idle_share": max(0.0, 1 - busy / (prof_wall * 1e3)),
        "device_ms_per_frame_top": {
            k[:90]: {"ms": v / n, "calls_per_frame": calls[k] / n}
            for k, v in dev.most_common(12)},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
