#!/usr/bin/env python3
"""Encode throughput benchmark of the PyTorch/CUDA port: 720p30 synthetic
clip on one card.

Twin of tools/bench_encode.py. Measures TorchEncoder
(models/torch_encoder.py: decision, transform, reconstruction and loop
filter on the card, entropy packing on the host) against the reference
`vpxenc` (generic C build, single core) on the same content at the same
fixed quantizer, and reports fps, bytes and luma PSNR for both, so that
speed and quality are compared on equal footing. The port's payloads are
decoded by TorchDecoder on the same device for the PSNR, as are the
reference's.

The reference rows run only when $REF_BUILD names a directory holding a
`vpxenc` build (and not under --skip-ref). With --device cpu the encoder
runs its plain PyTorch path on the CPU, which is no device measurement.

Usage: python tools/bench_encode_torch.py [--frames 30] [--q 24]
       [--w 1280 --h 720] [--cpu-used 0] [--skip-ref] [--device cuda|cpu]
Prints one JSON object: {"torch_speed<N>": {"fps", "bytes", "psnr_y"},
"ref_vpxenc_<tag>": {...}, ...}.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from make_test_vectors import synth_clip  # noqa: E402
from libvpx_opencl_tpu_torch.models.torch_decoder import \
    TorchDecoder  # noqa: E402
from libvpx_opencl_tpu_torch.models.torch_encoder import \
    TorchEncoder  # noqa: E402
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf  # noqa: E402
from libvpx_opencl_tpu_torch.utils.y4m import write_y4m  # noqa: E402

# vpxenc CLI quantizer (0-63) -> frame qindex (0-127): q_trans
# (onyx_if.c q_trans[]); inverse used to hand vpxenc our qindex
Q_TRANS = [0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 12, 13, 15, 17, 18, 19,
           20, 21, 23, 24, 25, 26, 27, 28, 29, 30, 31, 33, 35, 37,
           39, 41, 43, 45, 47, 49, 51, 53, 55, 57, 59, 61, 64, 67,
           70, 73, 76, 79, 82, 85, 88, 91, 94, 97, 100, 103, 106,
           109, 112, 115, 118, 121, 124, 127]


def psnr_y(payloads, frames, device):
    """Mean luma PSNR of the payloads decoded by TorchDecoder."""
    dec = TorchDecoder(device=device)
    acc = []
    for payload, (y, _u, _v) in zip(payloads, frames):
        _show, (dy, _du, _dv) = dec.decode_frame(payload)
        d = y.astype(np.float64) - dy.astype(np.float64)
        mse = (d * d).mean()
        acc.append(99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
    return sum(acc) / len(acc)


def encode_torch(frames, args):
    """TorchEncoder over the clip after the warm-up; returns (seconds,
    payloads)."""
    device = torch.device(args.device)

    def new_encoder():
        return TorchEncoder(args.w, args.h, qindex=args.q,
                            cpu_used=args.cpu_used, device=device)

    # warm-up: every frame kind (KF + inter at reference-ring
    # cardinalities 1/2/3; refresh flags steer the identity dedup), on the
    # clip's frames 0-2 or, in a shorter clip, its last frame
    enc = new_encoder()
    f1, f2 = frames[min(1, len(frames) - 1)], frames[min(2, len(frames) - 1)]
    enc.encode_frame(*frames[0], keyframe=True)
    enc.encode_frame(*f1, keyframe=False)                 # 2 refs
    enc.encode_frame(*f2, keyframe=False, refresh_golden=True)  # gold != alt
    enc.encode_frame(*f1, keyframe=False)                 # 3 refs
    enc = new_encoder()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    payloads = [enc.encode_frame(*f, keyframe=(i == 0))
                for i, f in enumerate(frames)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, payloads


def main(argv=None):
    """Print the JSON object; returns (it, the port's payloads)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--q", type=int, default=24, help="frame qindex")
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--cpu-used", type=int, default=0,
                    help="encoder speed level (SpeedFeatures ladder)")
    ap.add_argument("--skip-ref", action="store_true",
                    help="skip the reference vpxenc rows")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error("--frames must be at least 1")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("bench_encode_torch: no CUDA card; pass "
                         "--device cpu")

    frames = synth_clip(args.w, args.h, args.frames, seed=42)
    out = {}
    dt, payloads = encode_torch(frames, args)
    out[f"torch_speed{args.cpu_used}"] = {
        "fps": round(len(frames) / dt, 2),
        "bytes": sum(len(p) for p in payloads),
        "psnr_y": round(psnr_y(payloads, frames, args.device), 2)}

    # --- reference vpxenc (single core, generic C) ----------------------
    ref = os.environ.get("REF_BUILD")
    vpxenc = os.path.join(ref, "vpxenc") if ref else None
    if vpxenc and os.path.exists(vpxenc) and not args.skip_ref:
        with tempfile.TemporaryDirectory() as tmp:
            y4m = os.path.join(tmp, "bench_enc.y4m")
            write_y4m(y4m, frames, args.w, args.h)
            cli_q = min(range(64), key=lambda i: abs(Q_TRANS[i] - args.q))

            def ref_row(tag, extra):
                ivf_p = os.path.join(tmp, f"bench_enc_{tag}.ivf")
                cmd = [vpxenc, "--codec=vp8", "-o", ivf_p, y4m, "--ivf",
                       "--end-usage=0", "--target-bitrate=8000",
                       f"--min-q={cli_q}", f"--max-q={cli_q}",
                       "--kf-max-dist=9999", "--passes=1", "--threads=1",
                       "-t", "1"] + extra
                t0 = time.perf_counter()
                subprocess.run(cmd, check=True, capture_output=True)
                dt = time.perf_counter() - t0
                ref_payloads = [p for p, _ in read_ivf(ivf_p).frames]
                out[f"ref_vpxenc_{tag}"] = {
                    "fps": round(len(frames) / dt, 2),
                    "bytes": os.path.getsize(ivf_p) - 32 - 12 * len(frames),
                    "psnr_y": round(psnr_y(ref_payloads, frames,
                                           args.device), 2)}

            # quality-matched point for speed 0 (vpxenc's best quality)
            ref_row("good0", ["--good", "--cpu-used=0"])
            ref_row("good4", ["--good", "--cpu-used=4"])
            # realtime speed point (the fork's fastest honest CPU config)
            ref_row("rt8", ["--rt", "--cpu-used=8"])
    print(json.dumps(out), flush=True)
    return out, payloads


if __name__ == "__main__":
    main()
