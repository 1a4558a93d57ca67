#!/usr/bin/env python3
"""Where the time goes in the port's encode (PyTorch/CUDA).

Run from the repository root on a machine with a CUDA card:

    python3 tools/profile_torch_encode.py [--frames 4]
    python3 tools/profile_torch_encode.py --device cpu --w 64 --h 64

On the card it decodes the first frames of tests/vectors/bench_1080p.ivf
with the port's decoder (cropped to --w x --h, 1920x1080 by default), then
encodes them (1 key + the rest inter) with TorchEncoder at qindex 24,
under each of two feature sets: the default speed features (B_PRED and
trellis on) and SLICE2_SF (both off); per feature set once to warm up and
once with timers. Every timed stage is bracketed by
torch.cuda.synchronize(), so stage times are wall-clock seconds of host +
device work and add up to the frame:
  * decision (the _decide_*_fn hooks: motion search + RD choice), and
    inside it K3 (ops/me_sad.sad_grid, per launch) and the B_PRED
    candidate (`_bpred_rd`);
  * encode (the _encode_fn hook), split into the trellis on the inter MBs
    (`_trellis_mbs`), the encode wavefront
    (models/wavefront.encode_recon_planes: the inter batch, then K5), inside
    it K5's launch (`_k5_launch`), and the rest, which is MC and the
    trellis's transform;
  * loop filter + borders (the _lf_fn hook: K2);
  * host pack (Encoder._pack);
  * other: uploads, host grids, MV->mode mapping.
Each frame's row also holds its number of intra MBs, of B_PRED MBs and of
the dependency levels the plain version walks (`intra_levels`), and K6's
launches in the frame (`k6_launches`, beside the `trellis` stage: one per
inter frame with inter MBs at default features on the card). Then a
third encoder of each feature set encodes the same frames again, the last
one under torch.profiler, for the device's busy time and idle share on an
inter frame.

With --device cpu the encoder runs its plain PyTorch path on a synthetic
clip (tools/make_test_vectors.synth_clip) on the CPU, which is no device
measurement: there is no K5 and no profiler run, and the encode wavefront
is split into the plain version's B_PRED lanes (`_bpred_lanes`) and its
dependency levels (`_encode_mb_step`, one call per level).

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


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--h", type=int, default=1080)
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("profile_torch_encode: needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return None
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import numpy as np
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.models import torch_encoder as TE
    from libvpx_opencl_tpu_torch.models import wavefront as EW
    from libvpx_opencl_tpu_torch.ops import _cuda
    from libvpx_opencl_tpu_torch.ops import me_sad
    from libvpx_opencl_tpu_torch.ops import wavefront as W

    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        stream = os.path.join(HERE, "tests", "vectors", "bench_1080p.ivf")
        frames = [tuple(np.ascontiguousarray(p[:h, :w]) for p, h, w in zip(
            planes, (args.h, args.h // 2, args.h // 2),
            (args.w, args.w // 2, args.w // 2)))
            for planes in TD.decode_ivf_torch(stream, limit=args.frames,
                                              device="cuda")]
        sync = torch.cuda.synchronize
    else:
        from make_test_vectors import synth_clip
        card = "cpu (no device measurement)"
        frames = synth_clip(args.w, args.h, args.frames)
        sync = lambda: None  # noqa: E731
    print(card, flush=True)

    stage = collections.Counter()       # seconds per stage, current frame
    features = {"default": TE.SpeedFeatures(), "slice2": TE.SLICE2_SF}

    def timed(fn, key):
        def wrapper(*a, **k):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                sync()
                stage[key] += time.perf_counter() - t0
        return wrapper

    class TimedEncoder(TE.TorchEncoder):
        _decide_key_fn = staticmethod(timed(TE._decide_rd_key, "decision"))
        _decide_inter_fn = staticmethod(timed(TE._decide_rd_inter,
                                              "decision"))
        _encode_fn = staticmethod(timed(TE._encode_device, "encode"))
        _lf_fn = staticmethod(timed(TE._lf_device, "loop_filter"))
        _pack = timed(TE.TorchEncoder._pack, "host_pack")

    def encode_all(cls, frames, sf, per_frame=None):
        enc = cls(args.w, args.h, qindex=24, device=args.device)
        enc.sf = sf
        for frame in frames:
            stage.clear()
            k6 = _cuda.launches["trellis"]
            sync()
            t0 = time.perf_counter()
            payload = enc.encode_frame(*frame)
            sync()
            if per_frame is not None:
                row = dict(stage, total=time.perf_counter() - t0,
                           bytes=len(payload), **shape.pop(),
                           k6_launches=_cuda.launches["trellis"] - k6)
                row["mc"] = row["encode"] - row["encode_wavefront"] - \
                    row.get("trellis", 0.0)
                row["other"] = row["total"] - sum(
                    row[k] for k in ("decision", "encode", "loop_filter",
                                     "host_pack"))
                per_frame.append(row)
        return enc

    ew_fn = EW.encode_recon_planes
    ew_timed = timed(ew_fn, "encode_wavefront")
    shape = []

    def ew_probe(R, C, *a):
        # after 3 sources and 3 predictions: mode, uv_mode, intra
        intra = a[8].cpu().numpy()
        bpred = intra & (a[6].cpu().numpy() == W.B_PRED_M)
        shape.append({
            "intra_mbs": int(intra.sum()), "bpred_mbs": int(bpred.sum()),
            "levels": int(EW.intra_levels(R, C, intra, bpred).max()) + 1})
        return ew_timed(R, C, *a)

    probes = [(EW, "encode_recon_planes", ew_probe),
              (me_sad, "sad_grid", timed(me_sad.sad_grid, "k3_sad_grid")),
              (TE, "_bpred_rd", timed(TE._bpred_rd, "bpred_decision")),
              (TE, "_trellis_mbs", timed(TE._trellis_mbs, "trellis"))]
    if on_card:
        probes.append((EW, "_k5_launch", timed(EW._k5_launch, "k5")))
    else:
        probes += [(EW, "_bpred_lanes", timed(EW._bpred_lanes,
                                              "bpred_lanes")),
                   (EW, "_encode_mb_step", timed(EW._encode_mb_step,
                                                 "level_steps"))]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {"card": card, "device": args.device, "frames": len(frames),
           "size": [args.w, args.h]}
    for name, sf in features.items():
        encode_all(TE.TorchEncoder, frames, sf)              # warm-up
        saved = [getattr(mod, attr) for mod, attr, _ in probes]
        for mod, attr, fn in probes:
            setattr(mod, attr, fn)
        rows = []
        try:
            encode_all(TimedEncoder, frames, sf, rows)
        finally:
            for (mod, attr, _), fn in zip(probes, saved):
                setattr(mod, attr, fn)
        out[name] = {
            "keyframe_s": rows[0],
            "inter_frames_s": rows[1:],
            "inter_fps": (len(rows) - 1) / sum(r["total"] for r in rows[1:]),
        }
        if on_card:
            enc = encode_all(TE.TorchEncoder, frames[:-1], sf)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                enc.encode_frame(*frames[-1])
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            dev = collections.Counter()
            calls = collections.Counter()
            # kernel events only: an operator's row repeats its kernels' time
            for ev in prof.key_averages():
                t = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0))
                if t > 0 and ev.device_type == DeviceType.CUDA:
                    dev[ev.key] += t / 1e3          # us -> ms
                    calls[ev.key] += ev.count
            busy = sum(dev.values())
            out[name]["profiled_inter_frame"] = {
                "wall_s": prof_wall, "device_busy_ms": busy,
                "device_idle_share": max(0.0, 1 - busy / (prof_wall * 1e3)),
                "kernel_launches": sum(calls.values()),
                "device_ms_top": {
                    k[:90]: {"ms": v, "calls": calls[k]}
                    for k, v in dev.most_common(10)}}
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 2)
