"""tpuvpxdec — VP8 decoder CLI with vpxdec-compatible flags, on the port.

Twin of libvpx_opencl_tpu/cli/tpuvpxdec.py with the same flags and the
same output. Mirrors the reference tool's interface (vpxdec.c:66-130 arg
table, out_open/out_put:322-371 output patterns, --md5 conformance mode,
--summary timing) over TorchDecoder on the CUDA card (or the golden host
decoder with --golden):

    python -m libvpx_opencl_tpu_torch.cli.tpuvpxdec X.ivf --md5
"""
from __future__ import annotations

import argparse
import sys
import time


def expand_pattern(pattern, w, h, idx):
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "%" and i + 1 < len(pattern):
            code = pattern[i + 1]
            if code == "w":
                out.append(str(w))
            elif code == "h":
                out.append(str(h))
            elif code.isdigit():
                out.append(str(idx).zfill(int(code)))
            else:
                out.append(code)
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def main(argv=None, device="cuda"):
    """Run the CLI on `argv`; `device` is the torch device TorchDecoder
    decodes on (the tests pass "cpu"; there is no flag for it)."""
    p = argparse.ArgumentParser(prog="tpuvpxdec")
    p.add_argument("input")
    p.add_argument("--codec", default="vp8")
    p.add_argument("--i420", action="store_true",
                   help="Output raw I420 frames")
    p.add_argument("--yv12", action="store_true",
                   help="Output raw YV12 frames")
    p.add_argument("--md5", action="store_true",
                   help="Compute the MD5 sum of the decoded frame")
    p.add_argument("-o", "--output", default=None,
                   help="Output file name pattern (%%w/%%h/%%<n> escapes)")
    p.add_argument("--limit", type=int, default=0,
                   help="Stop decoding after n frames")
    p.add_argument("--noblit", action="store_true",
                   help="Don't process the decoded frames")
    p.add_argument("--progress", action="store_true")
    p.add_argument("--summary", action="store_true",
                   help="Show timing summary")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for compatibility (partition decode "
                        "parallelism is automatic)")
    p.add_argument("--golden", action="store_true",
                   help="use the pure-host golden decoder instead of the "
                        "device pipeline")
    p.add_argument("--error-concealment", action="store_true")
    args = p.parse_args(argv)

    from ..utils.ivf import read_ivf
    from ..utils.md5 import frame_md5
    from ..utils.webm import read_webm
    if args.golden:
        from ..models.refdec import RefDecoder
        dec = type("D", (RefDecoder,), {"use_native": True})()
    else:
        from ..models.torch_decoder import TorchDecoder
        dec = TorchDecoder(device=device)

    with open(args.input, "rb") as fprobe:
        magic = fprobe.read(4)
    if magic == b"\x1aE\xdf\xa3":  # EBML: WebM input (nestegg role)
        ws = read_webm(args.input)
        stream = type("S", (), {"frames": [(p_, tc) for p_, tc, _k
                                           in ws.frames]})()
    else:
        stream = read_ivf(args.input)
    t0 = time.time()
    n = 0
    single_out = None
    for payload, _pts in stream.frames:
        show = dec.decode_frame_core(payload)
        if not show:
            continue
        n += 1
        if not args.noblit:
            y, u, v = dec.frame_to_show.visible()
            if args.yv12:
                u, v = v, u
            if args.md5:
                digest = frame_md5(y, u, v)
                name = expand_pattern(args.output, y.shape[1], y.shape[0],
                                      n) if args.output else f"frame-{n}"
                print(f"{digest}  {name}")
            elif args.output:
                name = expand_pattern(args.output, y.shape[1], y.shape[0], n)
                if "%" in args.output:
                    with open(name, "wb") as f:
                        f.write(y.tobytes() + u.tobytes() + v.tobytes())
                else:
                    if single_out is None:
                        single_out = open(name, "wb")
                    single_out.write(y.tobytes() + u.tobytes() + v.tobytes())
        if args.progress:
            print(f"decoded frame {n}", file=sys.stderr)
        if args.limit and n >= args.limit:
            break
    dt = time.time() - t0
    if single_out:
        single_out.close()
    if args.summary:
        print(f"{n} decoded frames/{n} showed frames in {int(dt*1e6)} us "
              f"({n/dt:.2f} fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
