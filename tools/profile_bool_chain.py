#!/usr/bin/env python3
"""Time the VP8 bool decoder's read chain alone on the card, one thread:
what a dependent bool read costs without the detokenizer around it, to
set beside K4's ns per read (chip_smoke.py, csrc/detokenize.cu).

Builds tools/profile_bool_chain.cu (K4's read_bool from
csrc/boolread.cuh in a loop) with nvcc (sm_90a) into the port's
git-ignored _build/ and runs as many reads as K4 makes on the keyframe
of tests/vectors/bench_1080p.ivf (6,330,538) over that frame's bytes, in
three modes: a fixed probability; the probability loaded from shared
memory at an index made of the last bit; a branch on the last bit picking
the probability. Each mode runs twice; prints ns per read, the SM clock
read during a run, and the card's name and power limit.

Usage: python3 tools/profile_bool_chain.py [--reads N]
"""
import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libvpx_opencl_tpu_torch.ops import _cuda  # noqa: E402
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf  # noqa: E402

MODES = ("fixed probability", "probability from shared memory",
         "branch picks the probability")


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def build():
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    so = os.path.join(_cuda.BUILD_DIR, "libprofile_bool_chain.so")
    subprocess.run([_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", _cuda.CSRC,
                    "-o", so, os.path.join(HERE, "profile_bool_chain.cu")],
                   check=True)
    fn = ctypes.CDLL(so).bool_chain
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, i, i, i, vp, vp, vp]
    fn.restype = i
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=6330538)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bool_chain: needs a CUDA card")
    card = smi("name,power.limit")
    fn = build()
    payload = read_ivf(os.path.join(os.path.dirname(HERE), "tests",
                                    "vectors", "bench_1080p.ivf")).frames[0][0]
    dev = torch.device("cuda")
    buf = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(dev)
    table = torch.tensor([30, 200, 128, 90, 250, 10, 160, 140, 220, 70, 128,
                          190, 40, 240, 100, 128], dtype=torch.int32,
                         device=dev)
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for rep in range(2):
        for mode, name in enumerate(MODES):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
            e0.record()
            _cuda.check(fn(buf.data_ptr(), buf.numel(), args.reads, mode,
                           table.data_ptr(), out.data_ptr(), stream),
                        "bool_chain")
            e1.record()
            clocks = smi("clocks.sm,clocks.max.sm")   # while it runs
            e1.synchronize()
            ms = e0.elapsed_time(e1)
            print(f"run {rep}, {name}: {ms:.3f} ms for {args.reads} reads, "
                  f"{ms * 1e6 / args.reads:.2f} ns/read; SM clock {clocks} "
                  f"(now, max); bytes read {int(out[1])} [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
