#!/usr/bin/env python3
"""K6 (the trellis) and K4 (the device detokenizer) on the card, each
beside other builds of it, in one process.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/profile_k4_k6.py [--frames 10] [--k4-frames 16]
        [--k6-src OTHER.cu ...] [--k6-wide-src OTHER.cu ...]
        [--k4-src OTHER.cu ...]

K6: it decodes the first --frames frames of tests/vectors/bench_1080p.ivf
with TorchDecoder and encodes them (1 key + the rest inter) with
TorchEncoder at qindex 24 and the default speed features. In that encode
every K6 launch (`ops/rd_device.py:k6_launch`) launches each build in turn
on the same inputs, the first build in turn from frame to frame, each
between CUDA events ("in the encoder"; the summary takes the median over
frames, since a build's first launch also loads its module); the
package's output goes on. Then
on every inter frame's inputs each build's launch alone (CUDA events,
median of 3 rounds, the builds in turns), queued behind a ~50 us sleep
kernel (the kernel's time) and from an idle card (with the host's launch
path, as chip_smoke.py timed K6 before its redesign). An --k6-src build has K6's C
entry point (`trellis`) and takes the package's int8/int16 value tables;
an --k6-wide-src build takes the int32 ones (`ops/rd_device.py:
_value_tables`), as K6 did before its redesign.

K4: tools/bench_entropy_torch.py's probe over the first --k4-frames frames
of bench_1080p.ivf keeps every frame's inputs; on each, each build's
launch alone and through the wrapper (`detokenize_frame_device` with the
inputs on the card: the zero-fill of qcoeff and the launch, by CUDA
events) with the build swapped in, each the mean of two runs, the builds
in turns (first to last, then last to first). An --k4-src build has K4's
C entry point (`detokenize`).

Every build's outputs must equal the package's. Builds go to
libvpx_opencl_tpu_torch/_build/profile_k4_k6/. Prints the card (nvidia-smi
name, power limit), each build's ptxas registers and spills, one line per
frame and one JSON line. It imports nothing of JAX or of the JAX package.
"""
import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

from profile_k5 import bind, build, card_line  # noqa: E402

BENCH = os.path.join(HERE, "tests", "vectors", "bench_1080p.ivf")
# a K6 launch alone is timed queued behind a sleep kernel of this many
# clocks (~50 us), so that its events hold the kernel and not the host's
# launch path; "from an idle card" it is timed as K6 was before its redesign, the first
# event recorded on an idle card
SLEEP_CYCLES = 100_000


def ptxas_lines(report):
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln]


def decoded_frames(n):
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
    src = []
    dec = TD.TorchDecoder(device="cuda")
    for payload, _pts in read_ivf(BENCH).frames:
        if dec.decode_frame_core(payload):
            src.append(tuple(p.copy() for p in dec.frame_to_show.visible()))
        if len(src) == n:
            break
    return src


def k6_profile(torch, card, frames, variants, wide):
    """K6 in the encoder and alone, per build; returns the JSON rows."""
    from libvpx_opencl_tpu_torch.models import torch_encoder as TE
    from libvpx_opencl_tpu_torch.ops import _cuda
    from libvpx_opencl_tpu_torch.ops import rd_device as RD

    def launch(name, fn, ins, out):
        if name in wide:
            ins = ins[:9] + RD._value_tables(ins[0].device) + ins[11:]
        dev = ins[0].device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(t.data_ptr() for t in ins[:13]), ins[0].shape[0],
                    out[0].data_ptr(), out[1].data_ptr(), stream)
        _cuda.check(rc, f"K6 {name}")

    names = list(variants)
    kept, in_enc = [], {n: [] for n in names}
    k6_fn = RD.k6_launch

    def each_build(ins, out):
        i = len(kept)
        kept.append((ins, out))
        order = names[i % len(names):] + names[:i % len(names)]
        outs = {}
        for name in order:
            o = out if name == "package" else tuple(
                torch.empty_like(t) for t in out)
            e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
            e0.record()
            launch(name, variants[name], ins, o)
            e1.record()
            outs[name] = (o, e0, e1)
        _cuda.count_launch("trellis")
        torch.cuda.synchronize()
        for name, (o, e0, e1) in outs.items():
            in_enc[name].append(e0.elapsed_time(e1))
            if any(not torch.equal(a, b) for a, b in zip(o, out)):
                raise SystemExit(f"profile_k4_k6: K6 {name} differs from "
                                 f"the package's on inter frame {i + 1}")

    RD.k6_launch = each_build
    try:
        enc = TE.TorchEncoder(1920, 1080, qindex=24, device="cuda")
        for f in frames:
            enc.encode_frame(*f)
    finally:
        RD.k6_launch = k6_fn
    torch.cuda.synchronize()

    rows = []
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    for i, (ins, out) in enumerate(kept):
        times = {n: [] for n in names}
        idle = {n: [] for n in names}
        for _ in range(3):
            for name in names + names[::-1]:
                for queued in (True, False):
                    o = tuple(torch.empty_like(t) for t in out)
                    torch.cuda.synchronize()
                    if queued:
                        torch.cuda._sleep(SLEEP_CYCLES)
                    e0.record()
                    launch(name, variants[name], ins, o)
                    e1.record()
                    torch.cuda.synchronize()
                    (times if queued else idle)[name].append(
                        e0.elapsed_time(e1))
        row = {"inter_frame": i + 1, "mbs": int(ins[0].shape[0]),
               "alone_ms": {n: statistics.median(t)
                            for n, t in times.items()},
               "alone_idle_ms": {n: statistics.median(t)
                                 for n, t in idle.items()},
               "in_encoder_ms": {n: in_enc[n][i] for n in names}}
        rows.append(row)
        print(f"K6 inter frame {i + 1} ({row['mbs']} inter MBs): alone ms "
              + ", ".join(f"{n} {v:.4f}" for n, v in row["alone_ms"].items())
              + "; alone from an idle card ms " + ", ".join(
                  f"{n} {v:.4f}" for n, v in row["alone_idle_ms"].items())
              + "; in the encoder ms " + ", ".join(
                  f"{n} {v:.4f}" for n, v in row["in_encoder_ms"].items())
              + f" [{card}]", flush=True)
    return rows


def k4_profile(torch, card, n_frames, variants):
    """K4 alone and through the wrapper, per build; returns the rows."""
    import bench_entropy_torch as tool
    from libvpx_opencl_tpu_torch.ops import _cuda
    from libvpx_opencl_tpu_torch.ops import entropy_device as ED

    dev = torch.device("cuda")
    probe = tool.measure(BENCH, n_frames, "cuda", keep=range(n_frames))
    fns = _cuda.load()
    package = fns["detokenize"]
    names = list(variants)
    rows = []
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    try:
        for f in range(n_frames):
            R, C, P, *arrays = probe.kept[f]
            t = [torch.from_numpy(a).to(dev) for a in arrays]
            N = R * C
            want = None
            alone = {n: [] for n in names}
            wrapper = {n: [] for n in names}
            for name in names + names[::-1]:
                fns["detokenize"] = variants[name]
                out = (torch.zeros((N, 25, 16), dtype=torch.int32,
                                   device=dev),
                       torch.empty((N, 25), dtype=torch.int32,
                                   device=dev),
                       torch.empty(N, dtype=torch.int32, device=dev),
                       torch.empty((P, 4), dtype=torch.int32,
                                   device=dev))
                torch.cuda.synchronize()
                e0.record()
                ED.launch(R, C, P, *t, *out)
                e1.record()
                torch.cuda.synchronize()
                alone[name].append(e0.elapsed_time(e1))
                e0.record()
                got = ED.detokenize_frame_device(R, C, P, *t)
                e1.record()
                torch.cuda.synchronize()
                wrapper[name].append(e0.elapsed_time(e1))
                if want is None:
                    want = got
                for g in (out, got):
                    if any(not torch.equal(a, b)
                           for a, b in zip(g, want)):
                        raise SystemExit(
                            f"profile_k4_k6: K4 {name} differs from "
                            f"the package's on frame {f}")
            row = {"frame": f, "alone_ms": {n: statistics.median(v)
                                            for n, v in alone.items()},
                   "wrapper_ms": {n: statistics.median(v)
                                  for n, v in wrapper.items()}}
            rows.append(row)
            print(f"K4 frame {f}: alone ms " + ", ".join(
                f"{n} {v:.3f}" for n, v in row["alone_ms"].items())
                + "; through the wrapper ms " + ", ".join(
                    f"{n} {v:.3f}" for n, v in row["wrapper_ms"].items())
                + f" [{card}]", flush=True)
    finally:
        fns["detokenize"] = package
    return rows


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--k4-frames", type=int, default=16)
    ap.add_argument("--k6-src", action="append", default=[])
    ap.add_argument("--k6-wide-src", action="append", default=[],
                    help="a K6 source that takes int32 value tables")
    ap.add_argument("--k4-src", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_k4_k6: no CUDA card")
    from libvpx_opencl_tpu_torch.ops import _cuda

    card = card_line()
    print(card, flush=True)
    fns = _cuda.load()
    k6 = {"package": fns["trellis"]}
    k4 = {"package": fns["detokenize"]}
    ptxas = {"trellis package": ptxas_lines(
        _cuda.ptxas_report.get("trellis", "")),
        "detokenize package": ptxas_lines(
            _cuda.ptxas_report.get("detokenize", ""))}
    wide = set()
    for kind, srcs, table, entry in (
            ("k6", args.k6_src, k6, "trellis"),
            ("k6w", args.k6_wide_src, k6, "trellis"),
            ("k4", args.k4_src, k4, "detokenize")):
        for i, src in enumerate(srcs):
            so, rep = build(src, f"{kind}_src{i}", "profile_k4_k6")
            name = f"{kind}:{src}"
            table[name] = bind(so, entry)
            ptxas[f"{entry} {name}"] = ptxas_lines(rep)
            if kind == "k6w":
                wide.add(name)
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"  ptxas {name}: {ln}", flush=True)
    k6_rows = k6_profile(torch, card, decoded_frames(args.frames), k6, wide)
    k4_rows = k4_profile(torch, card, args.k4_frames, k4)

    def mean(rows, key, name):
        return statistics.mean(r[key][name] for r in rows)

    def median(rows, key, name):
        return statistics.median(r[key][name] for r in rows)

    summary = {"card": card, "ptxas": ptxas,
               "k6": {n: {"alone_ms": mean(k6_rows, "alone_ms", n),
                          "alone_idle_ms": mean(k6_rows, "alone_idle_ms", n),
                          "in_encoder_median_ms": median(
                              k6_rows, "in_encoder_ms", n)}
                      for n in k6},
               "k4": {n: {"alone_key_ms": k4_rows[0]["alone_ms"][n],
                          "alone_inter_ms": statistics.mean(
                              r["alone_ms"][n] for r in k4_rows[1:]),
                          "wrapper_key_ms": k4_rows[0]["wrapper_ms"][n],
                          "wrapper_inter_ms": statistics.mean(
                              r["wrapper_ms"][n] for r in k4_rows[1:])}
                      for n in k4},
               "k6_rows": k6_rows, "k4_rows": k4_rows}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
