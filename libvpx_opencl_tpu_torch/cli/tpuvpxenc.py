"""tpuvpxenc — VP8 encoder CLI with vpxenc-compatible flags.

Mirrors the reference tool's interface (vpxenc.c arg tables: --target-bitrate,
--end-usage, --kf-max-dist, --token-parts, --psnr, IVF output) over the
framework encoder with the host rate-control layer. The frames are encoded
by TorchEncoder on the CUDA card (the pixel pipeline on the device, entropy
packing, rate control and the two-pass first pass on the host); --golden
selects the pure-host golden Encoder instead:

    python -m libvpx_opencl_tpu_torch.cli.tpuvpxenc in.y4m -o out.ivf
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None, device="cuda"):
    """Run the CLI on `argv`; `device` is the torch device TorchEncoder
    runs on (the default needs a CUDA card). --golden encodes with the
    host Encoder and never touches `device`."""
    p = argparse.ArgumentParser(prog="tpuvpxenc")
    p.add_argument("input", help="input .y4m file")
    p.add_argument("-o", "--output", required=True, help="output IVF file")
    p.add_argument("--codec", default="vp8")
    p.add_argument("--ivf", action="store_true", default=True)
    p.add_argument("--target-bitrate", type=int, default=256,
                   help="kbps (end-usage vbr/cbr)")
    p.add_argument("--end-usage", default="vbr", choices=["vbr", "cbr", "cq"])
    p.add_argument("--cq-level", type=int, default=24,
                   help="fixed quantizer index for --end-usage=cq")
    p.add_argument("--min-q", type=int, default=4)
    p.add_argument("--max-q", type=int, default=63)
    p.add_argument("--kf-max-dist", type=int, default=128)
    p.add_argument("--kf-min-dist", type=int, default=0)
    p.add_argument("--token-parts", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--passes", type=int, default=1, choices=[1, 2])
    p.add_argument("--fpf", default=None,
                   help="first-pass stats file (two-pass)")
    p.add_argument("--auto-alt-ref", type=int, default=0,
                   help="1 = synthesize ARNR-filtered altref frames")
    p.add_argument("--arnr-maxframes", type=int, default=5)
    p.add_argument("--arnr-strength", type=int, default=6)
    p.add_argument("--lag-in-frames", type=int, default=16)
    p.add_argument("--golden-interval", type=int, default=0)
    p.add_argument("--cpu-used", type=int, default=0,
                   help="speed ladder: 0 exhaustive ME, B_PRED, trellis; "
                        "1-4 step-2 ME; 5-11 also no B_PRED, no trellis; "
                        "12+ also LAST only. The device encoder has no "
                        "SPLITMV and no SAD decision (--golden has both: "
                        "SPLITMV at 0-2, SAD decision at 8+)")
    p.add_argument("--psnr", action="store_true")
    p.add_argument("--tune", choices=["psnr", "ssim"], default="psnr",
                   help="ssim = activity masking "
                        "(vp8_activity_masking, encodeframe.c:81-357); "
                        "host encoder only, needs --golden")
    p.add_argument("--golden", action="store_true",
                   help="use the pure-host golden encoder instead of the "
                        "device pipeline")
    p.add_argument("--rate-hist", type=int, default=0, metavar="N",
                   help="show N-bucket per-frame rate histogram "
                        "(vpxenc.c show_rate_histogram)")
    p.add_argument("--q-hist", type=int, default=0, metavar="N",
                   help="show N-bucket quantizer histogram "
                        "(vpxenc.c show_q_histogram)")
    args = p.parse_args(argv)
    if args.tune == "ssim" and not args.golden:
        p.error("--tune ssim (activity masking) runs on the host encoder "
                "only: add --golden")

    from ..models.ratecontrol import RateController
    from ..ops.metrics import frame_psnr
    from ..utils.ivf import IvfStream, write_ivf
    from ..utils.y4m import Y4MReader

    rd = Y4MReader(args.input)
    # --cpu-used maps to the speed-feature ladder
    # (vp8_set_speed_features onyx_if.c:670 via encoder.speed_features):
    # 0 = everything on (exhaustive ME, SPLITMV, B_PRED, trellis),
    # 1-2 step-2 ME, 3-4 -SPLITMV, 5-7 -trellis/-B_PRED,
    # 8-11 SAD decision, 12+ LAST-only; the device encoder honours
    # exhaustive ME, B_PRED, trellis and multi-ref
    kw = dict(qindex=args.cq_level, token_parts=args.token_parts,
              golden_interval=args.golden_interval, cpu_used=args.cpu_used)
    if args.golden:
        from ..models.encoder import Encoder
        enc = Encoder(rd.w, rd.h, **kw)
        enc.tune_ssim = args.tune == "ssim"
    else:
        from ..models.torch_encoder import TorchEncoder
        enc = TorchEncoder(rd.w, rd.h, device=device, **kw)
    mb_count = ((rd.h + 15) // 16) * ((rd.w + 15) // 16)
    rc = None
    if args.passes == 2:
        from ..models import twopass
        stats = twopass.first_pass(Y4MReader(args.input))
        if args.fpf:
            twopass.save_stats(args.fpf, stats)
        rc = twopass.TwoPassController(
            stats, args.target_bitrate, rd.fps[0] / max(1, rd.fps[1]),
            mb_count, min_q=args.min_q, max_q=args.max_q)
    elif args.end_usage in ("vbr", "cbr"):
        rc = RateController(args.target_bitrate,
                            rd.fps[0] / max(1, rd.fps[1]), mb_count,
                            min_q=args.min_q, max_q=args.max_q,
                            end_usage=args.end_usage,
                            kf_max_dist=args.kf_max_dist)
    stream = IvfStream(width=rd.w, height=rd.h,
                       timebase_num=rd.fps[1], timebase_den=rd.fps[0])
    t0 = time.time()
    psnr_acc = []
    q_hist = []
    n = 0
    from ..models.ratecontrol import encode_frame_with_rc
    if args.auto_alt_ref:
        # ARNR altref pipeline driven by the Lookahead ring
        # (lookahead.c:63-208 role): frames stream through a lag-deep
        # buffer; two-pass mode places ARFs from pass-1 GF groups
        from ..models import twopass as _tp
        frame_src = rd
        if args.limit:
            import itertools
            frame_src = itertools.islice(rd, args.limit)
        frames = None
        if args.psnr:            # PSNR needs the originals kept
            frames = list(frame_src)
            frame_src = frames
        if isinstance(rc, _tp.TwoPassController):
            from ..models.arnr import encode_twopass_altref
            rc.auto_altref = True
            payloads = encode_twopass_altref(
                enc, rc, list(frame_src),
                max_frames=args.arnr_maxframes,
                strength=args.arnr_strength)
        else:
            from ..models.arnr import encode_stream_altref
            payloads = encode_stream_altref(
                enc, rc if isinstance(rc, RateController) else None,
                frame_src, lag=max(4, args.lag_in_frames),
                gf_interval=max(4, args.lag_in_frames // 2),
                max_frames=args.arnr_maxframes,
                strength=args.arnr_strength)
        n = 0
        for p in payloads:
            if not p:            # RC dropped the frame: nothing to write
                continue
            stream.frames.append((p, len(stream.frames)))
            n += p[0] & 0x10 and 1 or 0
        if args.psnr and frames:
            from ..models.refdec import RefDecoder
            d = type("D", (RefDecoder,), {"use_native": True})()
            shown = 0
            for p, _ in stream.frames:
                show, planes = d.decode_frame(p)
                if show and shown < len(frames):
                    psnr_acc.append(frame_psnr(frames[shown], planes)["all"])
                    shown += 1
    else:
        frames = rd
    for i, (y, u, v) in enumerate(frames if not args.auto_alt_ref else []):
        keyframe = (i == 0) or (args.kf_max_dist > 0 and
                                i % max(1, args.kf_max_dist) == 0)
        if rc is not None and hasattr(rc, "want_keyframe"):
            keyframe = keyframe or rc.want_keyframe()
        if isinstance(rc, RateController):
            # one-pass: full RC with the recode loop
            payload = encode_frame_with_rc(enc, rc, y, u, v,
                                           keyframe=keyframe)
        elif rc is not None:
            enc.qindex = rc.frame_q(keyframe)
            payload = enc.encode_frame(y, u, v, keyframe=keyframe)
            rc.update(enc.qindex, len(payload) * 8, keyframe)
        else:
            payload = enc.encode_frame(y, u, v, keyframe=keyframe)
        if not payload:          # RC dropped the frame: nothing to write
            continue
        stream.frames.append((payload, i))
        q_hist.append(int(enc.qindex))
        if args.psnr:
            # the device encoder keeps its reconstruction on the card;
            # the host Encoder decodes its payload into enc.dec
            shown = enc.dec.frame_to_show if args.golden else \
                enc.frame_to_show
            rec = shown.visible()
            psnr_acc.append(frame_psnr((y, u, v), rec)["all"])
        n += 1
        sys.stderr.write(f"\rPass 1/1 frame {n} "
                         f"{sum(len(f[0]) for f in stream.frames)}B")
        if args.limit and n >= args.limit:
            break
    if args.output.endswith(".webm"):
        from ..utils.webm import WebMStream, write_webm
        ws = WebMStream(width=rd.w, height=rd.h)
        fps = rd.fps[0] / max(1, rd.fps[1])
        for idx, (payload, pts) in enumerate(stream.frames):
            key = not (payload[0] & 1)
            ws.frames.append((payload, int(idx * 1000 / fps), key))
        write_webm(args.output, ws)
    else:
        write_ivf(args.output, stream)
    dt = time.time() - t0
    total = sum(len(f[0]) for f in stream.frames)
    fps = rd.fps[0] / max(1, rd.fps[1])
    kbps = total * 8 * fps / max(1, n) / 1000
    sys.stderr.write(f"\n{n} frames, {total} bytes ({kbps:.0f} kbps) "
                     f"in {dt:.1f}s ({n/dt:.2f} fps)\n")
    if args.psnr and psnr_acc:
        sys.stderr.write(f"Overall PSNR (avg-all): "
                         f"{sum(psnr_acc)/len(psnr_acc):.2f} dB\n")
    if args.rate_hist and stream.frames:
        sizes = [len(f[0]) * 8 * fps / 1000.0 for f in stream.frames]
        _show_histogram("Rate (kbps)", sizes, args.rate_hist)
    if args.q_hist and q_hist:
        _show_histogram("Quantizer", [float(q) for q in q_hist],
                        args.q_hist)
    return 0


def _show_histogram(title, values, buckets):
    """vpxenc.c show_histogram role: bucketed star-bar frame counts."""
    lo, hi = min(values), max(values)
    span = max(hi - lo, 1e-9)
    counts = [0] * buckets
    for v in values:
        b = min(buckets - 1, int((v - lo) / span * buckets))
        counts[b] += 1
    peak = max(counts)
    sys.stderr.write(f"\n{title} histogram ({len(values)} frames)\n")
    for b, cnt in enumerate(counts):
        b_lo = lo + span * b / buckets
        b_hi = lo + span * (b + 1) / buckets
        bar = "*" * max(1 if cnt else 0, int(40 * cnt / max(peak, 1)))
        sys.stderr.write(f"  {b_lo:9.1f}-{b_hi:9.1f}: {cnt:4d} {bar}\n")


if __name__ == "__main__":
    sys.exit(main())
