#!/usr/bin/env python3
"""Measure K4, the port's device detokenizer (ops/entropy_device.py,
csrc/detokenize.cu), against the host C++ detokenizer on a stream.

Twin of tools/bench_entropy.py for the PyTorch/CUDA port. The host
decoder's entropy layer (headers, modes and MVs, the native C++
detokenizer) runs every frame; each frame's token partitions then go
through K4's wrapper, and K4's qcoeff, eobs and skip must equal the host's
on every MB that carries tokens (the gate of tests/test_entropy_device.py),
or the tool raises. The probe reconstructs no pixels: no token depends on
one, and the host decoder's Python reconstruction would take minutes per
1080p frame.

Per frame it reports the host C++ detokenize ms and K4's ms: by CUDA
events around the wrapper call with the inputs already on the card (the
launch, and the zero-fill of qcoeff before it), and by host clock through
the wrapper with the uploads; on the card one untimed call on the first
frame comes before. Beside them: the bytes uploaded for K4 (the
padded partitions and the per-MB flags) against the dense int16
coefficients TorchDecoder uploads per frame, and the card's name and
power limit. With --cpu the wrapper runs the plain version on the CPU, and
no device time is measured.

Usage: python tools/bench_entropy_torch.py [stream.ivf] [--frames N]
       [--device cuda|cpu] [--cpu]
The last line of the output is one JSON object with every number.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libvpx_opencl_tpu_torch.models.refdec import RefDecoder  # noqa: E402
from libvpx_opencl_tpu_torch.ops import _cuda  # noqa: E402
from libvpx_opencl_tpu_torch.ops import entropy_device as ED  # noqa: E402
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf  # noqa: E402

DEFAULT_STREAM = os.path.join(os.path.dirname(HERE), "tests", "vectors",
                              "part4_cif.ivf")
# TorchDecoder._prep_arrays hands _upload_qcoeff int16 qcoeff [N, 25, 16]
# every frame: the upload a device detokenizer would replace
COEF_UPLOAD_BYTES_PER_MB = 25 * 16 * np.dtype(np.int16).itemsize


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


class EntropyProbe(RefDecoder):
    """The host decoder's entropy layer alone, with K4 on every frame's
    tokens beside the host detokenizer. `keep`: frame indices whose K4
    inputs (numpy, with R, C, P first) are kept in `kept`."""

    use_native = True

    def __init__(self, device, keep=()):
        super().__init__()
        self.device = torch.device(device)
        self.keep = set(keep)
        self.kept = {}
        self.rows = []

    def _reconstruct(self):
        self._detokenize_all()

    def _swap_and_filter(self):
        if not self.refresh_entropy:
            self.fc = self.lfc.copy()

    def _detokenize_all(self):
        n = len(self.rows)
        inputs = ED.frame_inputs(self)
        R, C, P, *arrays = inputs
        if n in self.keep:
            self.kept[n] = inputs
        t0 = time.perf_counter()
        super()._detokenize_all()                 # host C++ path
        host_ms = (time.perf_counter() - t0) * 1e3

        cuda = self.device.type == "cuda"
        if cuda:
            if not self.rows:
                # one untimed call first: the first launch in a process
                # ran 30-390 ms longer than the same launch later
                ED.detokenize_frame_device(R, C, P, *(
                    torch.from_numpy(a).to(self.device) for a in arrays))
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        t = [torch.from_numpy(a).to(self.device) for a in arrays]
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        q, e, sk, _ = ED.detokenize_frame_device(R, C, P, *t)
        if cuda:
            ev1.record()
            torch.cuda.synchronize(self.device)
        wrapper_ms = (time.perf_counter() - t0) * 1e3

        live = arrays[-1].reshape(R, C) == 0
        q = q.cpu().numpy().reshape(R, C, 25, 16)
        e = e.cpu().numpy().reshape(R, C, 25)
        sk = sk.cpu().numpy().reshape(R, C)
        for name, got, want in (("qcoeff", q, self.qcoeff),
                                ("eobs", e, self.eobs),
                                ("skip", sk, self.skip)):
            if not np.array_equal(got[live], want[live]):
                raise RuntimeError(f"K4 {name} differs from the host "
                                   f"detokenizer on frame {n}")
        self.rows.append({
            "frame": n, "key": self.frame_type == 0,
            "partition_bytes": [int(b) for b in arrays[1]],
            "host_ms": host_ms,
            "k4_ms": ev0.elapsed_time(ev1) if cuda else None,
            "wrapper_ms": wrapper_ms,
            "upload_bytes": sum(int(a.nbytes) for a in arrays),
            "coef_upload_bytes": R * C * COEF_UPLOAD_BYTES_PER_MB})


def measure(stream, frames, device, keep=()):
    """Run the probe over the first `frames` frames; returns it (its
    `rows`, and `kept` inputs for the frames in `keep`)."""
    dec = EntropyProbe(device, keep)
    if dec.device.type == "cuda":
        _cuda.load()                       # the build is not a frame's time
    for payload, _ in read_ivf(stream).frames[:frames]:
        dec.decode_frame_core(payload)
    return dec


def report(stream, dec):
    """Print the per-frame table and a summary; returns the summary."""
    rows = dec.rows
    cuda = dec.device.type == "cuda"
    card = card_line() if cuda else "cpu (no card: no device time)"
    key = [r for r in rows if r["key"]]
    inter = [r for r in rows if not r["key"]]

    def med(name, rs):
        vals = [r[name] for r in rs if r[name] is not None]
        return statistics.median(vals) if vals else None

    print(f"stream: {stream} ({len(rows)} frames, {dec.mb_rows}x"
          f"{dec.mb_cols} MBs, {len(dec.bool_parts)} partitions) on "
          f"{dec.device}")
    print(f"card: {card}")
    for r in rows:
        k4 = "K4 device time not measured" if r["k4_ms"] is None else \
            f"K4 {r['k4_ms']:.3f} ms (events)"
        print(f"frame {r['frame']:3d}{' key' if r['key'] else '    '}: "
              f"{sum(r['partition_bytes']):8d} partition bytes, host C++ "
              f"{r['host_ms']:8.3f} ms, {k4}, wrapper with "
              f"uploads {r['wrapper_ms']:.3f} ms; == host")
    summary = {
        "stream": os.path.basename(stream), "frames": len(rows),
        "mbs": [dec.mb_rows, dec.mb_cols],
        "partitions": len(dec.bool_parts), "device": str(dec.device),
        "card": card,
        "host_ms_key": med("host_ms", key),
        "host_ms_inter": med("host_ms", inter),
        "k4_ms_key": med("k4_ms", key),
        "k4_ms_inter": med("k4_ms", inter),
        "wrapper_ms_key": med("wrapper_ms", key),
        "wrapper_ms_inter": med("wrapper_ms", inter),
        "upload_bytes": med("upload_bytes", rows),
        "coef_upload_bytes": med("coef_upload_bytes", rows),
        "rows": rows}
    what = "K4 (events)" if cuda else "plain version on the CPU"
    for kind in ("key", "inter"):
        t = summary[f"k4_ms_{kind}"] if cuda else \
            summary[f"wrapper_ms_{kind}"]
        if t is not None:
            print(f"median {kind} frame: host C++ "
                  f"{summary[f'host_ms_{kind}']:.3f} ms, {what} {t:.3f} ms")
    print(f"upload per frame (median): {summary['upload_bytes'] / 1024:.1f} "
          f"KB for K4 against {summary['coef_upload_bytes'] / 1024:.1f} KB "
          f"of int16 coefficients in TorchDecoder")
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stream", nargs="?", default=DEFAULT_STREAM)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_entropy_torch: no CUDA card; pass --cpu to "
                         "run the plain version on the CPU")
    return report(args.stream, measure(args.stream, args.frames, device))


if __name__ == "__main__":
    main()
