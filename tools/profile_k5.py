#!/usr/bin/env python3
"""K5, the encode wavefront kernel, alone on the card: its time on each
default-feature 1080p frame beside other builds of it.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/profile_k5.py [--frames 4] [--src OTHER.cu ...]

It decodes the first --frames frames of tests/vectors/bench_1080p.ivf with
TorchDecoder, encodes them (1 key + the rest inter) with TorchEncoder at
qindex 24 and the default speed features, and keeps every frame's
encode_recon_planes arguments. On each frame's inputs (after the inter
batch) it then times the launch alone by CUDA events (median of 3
rounds; in each round the builds take turns, first to last then last to
first) of the package's K5 (csrc/encode_wavefront.cu) and of each --src
file, a source with the same C entry point (`encode_wavefront`), such as
an earlier version of the kernel; every build's six outputs must equal
the package's.

Builds go to libvpx_opencl_tpu_torch/_build/profile_k5/. Prints the card
(nvidia-smi name, power limit), the ptxas report of each build, one line
per frame and one JSON line. It imports nothing of JAX or of the JAX
package.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build(src, name):
    """nvcc `src` into _build/profile_k5/lib<name>.so as ops/_cuda.py
    builds the kernels (csrc/ on the include path); returns (path, the
    ptxas report)."""
    from libvpx_opencl_tpu_torch.ops import _cuda
    out_dir = os.path.join(_cuda.BUILD_DIR, "profile_k5")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", _cuda.CSRC,
           "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{report}")
    return so, report


def bind(so):
    from libvpx_opencl_tpu_torch.ops import _cuda
    fn = ctypes.CDLL(so).encode_wavefront
    fn.argtypes = list(_cuda.KERNELS["encode_wavefront"][2])
    fn.restype = ctypes.c_int
    return fn


def capture(torch, frames):
    """Default-feature encode of the first `frames` 1080p frames; returns
    each frame's encode_recon_planes arguments (cloned)."""
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.models import torch_encoder as TE
    from libvpx_opencl_tpu_torch.models import wavefront as EW
    from libvpx_opencl_tpu_torch.utils.ivf import read_ivf

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(clone(v) for v in x)
        return x

    src = []
    dec = TD.TorchDecoder(device="cuda")
    for payload, _pts in read_ivf(os.path.join(
            HERE, "tests", "vectors", "bench_1080p.ivf")).frames:
        if dec.decode_frame_core(payload):
            src.append(tuple(p.copy() for p in dec.frame_to_show.visible()))
        if len(src) == frames:
            break
    kept = []
    fn = EW.encode_recon_planes

    def keep(*a):
        kept.append(clone(a))
        return fn(*a)

    EW.encode_recon_planes = keep
    try:
        enc = TE.TorchEncoder(1920, 1080, qindex=24, device="cuda")
        for f in src:
            enc.encode_frame(*f)
    finally:
        EW.encode_recon_planes = fn
    torch.cuda.synchronize()
    return kept


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--src", action="append", default=[],
                    help="another K5 source to time beside the package's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_k5: no CUDA card")
    from libvpx_opencl_tpu_torch.models import wavefront as EW
    from libvpx_opencl_tpu_torch.ops import _cuda
    from libvpx_opencl_tpu_torch.ops import wavefront as W

    card = card_line()
    print(card, flush=True)
    variants = {"package": _cuda.load()["encode_wavefront"]}

    def ptxas(name, rep):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    ptxas("package", _cuda.ptxas_report.get("encode_wavefront", ""))
    for i, src in enumerate(args.src):
        so, rep = build(src, f"k5_src{i}")
        ptxas(os.path.basename(src), rep)
        variants[os.path.basename(src)] = bind(so)
    kept = capture(torch, args.frames)

    def launch(fn, case):
        R, C, planes0, out0, srcs, params, rd, top = case
        planes = [x.clone() for x in planes0]
        out = [x.clone() for x in out0]
        y, u, v = planes
        b, b2 = W.BORDER, W.BORDER // 2
        sync = torch.zeros(R + 1, dtype=torch.int32, device=y.device)
        return planes, out, lambda: _cuda.check(fn(
            W._origin(y, b), y.stride(0), W._origin(u, b2), W._origin(v, b2),
            u.stride(0), *(t.data_ptr() for t in srcs), params.data_ptr(),
            *(None if x is None else x.data_ptr() for x in rd), R, C,
            int(top), *(t.data_ptr() for t in out), sync.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "K5")

    rows = []
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    for i, a in enumerate(kept):
        (R, C, sy, su, sv, iy, iu, iv, mode, uv_mode, intra, d1, d2, du,
         qidx, ext, bcost, rdm, rdd, top) = a
        planes0, out0, intra_np, bpred_np = EW._frame_setup(
            R, C, (sy, su, sv), (iy, iu, iv), mode, intra,
            (d1, d2, du, qidx), ext, bcost, top)
        params = EW.pack_encode_params(mode, uv_mode, intra, d1, d2, du,
                                       qidx)
        rd = (bcost, rdm, rdd) if bcost is not None else (None,) * 3
        case = (R, C, planes0, out0, (sy, su, sv), params, rd,
                top is not None)
        want = None
        for name, fn in variants.items():
            planes, out, go = launch(fn, case)
            go()
            torch.cuda.synchronize()
            got = list(out) + list(planes)
            if want is None:
                want = got
            elif any(not torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"profile_k5: {name} differs from the "
                                 f"package's K5 on frame {i}")
        times = {name: [] for name in variants}
        order = list(variants)
        for rnd in range(3):
            for name in order + order[::-1]:
                _, _, go = launch(variants[name], case)
                torch.cuda.synchronize()
                e0.record()
                go()
                e1.record()
                torch.cuda.synchronize()
                times[name].append(e0.elapsed_time(e1))
        ms = {name: statistics.median(ts) for name, ts in times.items()}
        row = {"frame": i, "intra": int(intra_np.sum()),
               "bpred": int(bpred_np.sum()), "ms": ms}
        rows.append(row)
        print(f"frame {i}: intra {row['intra']}, B_PRED {row['bpred']}; K5 "
              f"alone ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" [{card}]", flush=True)
    print(json.dumps({"card": card, "frames": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
