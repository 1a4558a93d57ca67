#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: bit-exact 1080p VP8 decode
throughput on one card, through TorchDecoder.

The twin of bench.py (which runs the JAX package on a TPU chip), with the
same workload, gate and baseline:

  * tests/vectors/bench_1080p.ivf (30 frames, 1 keyframe + 29 inter);
  * one warm-up decode of the whole stream, then BENCH_RUNS timed decodes
    (environment, default 5), and the median fps. The timed region is
    decode only, as `vpxdec --noblit --summary`: every frame is decoded
    and on the card when the clock stops, after torch.cuda.synchronize();
  * every shown frame's MD5 of every run, checked against the golden
    `.md5` outside the clock;
  * the baseline: the reference vpxdec on one CPU core, 19.6 fps.

Prints per-run lines and the card's name and power limit to stderr, and
as its last line one JSON object {"metric", "value", "unit",
"vs_baseline"}. When a frame is not bit-exact the value is 0 and the exit
code 1.

Usage: python3 bench_torch.py        (BENCH_RUNS=3 python3 bench_torch.py)
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from libvpx_opencl_tpu_torch.models.torch_decoder import \
    TorchDecoder  # noqa: E402
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf  # noqa: E402
from libvpx_opencl_tpu_torch.utils.md5 import (  # noqa: E402
    frame_md5, load_golden_md5s)

BASELINE_FPS = 19.6
STREAM = os.path.join(HERE, "tests", "vectors", "bench_1080p.ivf")


def card_line(device):
    if device.type != "cuda":
        return f"{device} (no card: not a device measurement)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def decode_run(frames, device):
    """One decode of the stream; returns (seconds, shown frames), the
    clock stopped once the card has finished every frame."""
    dec = TorchDecoder(device=device)
    shown = []
    t0 = time.perf_counter()
    for payload, _pts in frames:
        if dec.decode_frame_core(payload):
            shown.append(dec.frame_to_show)
    dec._sync()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, shown


def main(device="cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA card", file=sys.stderr)
        return 2
    frames = read_ivf(STREAM).frames
    golden = load_golden_md5s(STREAM + ".md5")
    runs = int(os.environ.get("BENCH_RUNS", "5"))
    print(f"card: {card_line(device)}", file=sys.stderr)

    decode_run(frames, device)                       # warm-up
    run_fps = []
    bit_exact = True
    for run in range(runs):
        dt, shown = decode_run(frames, device)
        md5s = [frame_md5(*fr.visible()) for fr in shown]
        bit_exact &= md5s == golden
        run_fps.append(len(shown) / dt)
        print(f"run {run}: {len(shown) / dt:.2f} fps "
              f"({dt * 1000 / len(shown):.1f} ms/f), "
              f"{'bit-exact' if md5s == golden else 'MD5 MISMATCH'}",
              file=sys.stderr)

    med = statistics.median(run_fps)
    print(f"median of {runs}: {med:.2f} fps (min {min(run_fps):.2f}, max "
          f"{max(run_fps):.2f})", file=sys.stderr)
    fps = med if bit_exact else 0.0
    unit = "frames/s/card" if device.type == "cuda" else "frames/s/cpu"
    print(json.dumps({
        "metric": "1080p_decode_fps_bit_exact_torch",
        "value": round(fps, 2),
        "unit": unit,
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }), flush=True)
    if not bit_exact:
        print("FAIL: decode not bit-exact", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
