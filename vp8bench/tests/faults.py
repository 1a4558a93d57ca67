"""Controls and planted faults: each changes the program (or what it is
asked to do) for one run and must make the run's `correct` come out
false.

Controls (the configuration's guarantee broken the way a faster program
might be tempted to break it), run at full size on the card by
`python3 vp8bench/tests/faults.py`, and at a small size by the tests:
  * decode `lf_skipped`: the loop filter (K2) left out of the decoder;
  * encode `coarser_quantizer`: the encoder quantizes at qindex 56, whose
    AC step (62) is the first at least twice qindex 24's (28), while the
    configuration states cq_level 24;
  * encode `cpu_used_1` and `cpu_used_5`: the encoder at the program's
    own faster speed-feature sets (`models/encoder.py:speed_features`):
    1, the step-2 motion search in place of the exhaustive one; 5, also
    no B_PRED, no trellis, no SPLITMV. The configuration states
    --cpu-used=0.

Faults a run can have, planted for the tests (a cell on one card has no
exchange between chips):
  * `ring_unchanged`: a step returns its state unchanged (the reference
    ring is not updated after inter frames);
  * `half_left_out`: half of the frame's MBs left out (decode: the bottom
    half of the planes not reconstructed; encode: the bottom half's
    coefficients not coded);
  * `answer_altered`: a pixel (decode) or a payload byte (encode) altered
    where it is produced.

Usage on a card:
    python3 vp8bench/tests/faults.py --workload <cell> --fault <name>
        --seeds 1,2,3 --seconds 10
prints each run's compared numbers as one JSON line per seed.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vp8bench.harness import spans as S  # noqa: E402

TD = "libvpx_opencl_tpu_torch.models.torch_decoder"
TE = "libvpx_opencl_tpu_torch.models.torch_encoder"
BORDER = 32


def _decoder_planes(change):
    """Patch decode_frame_device so that `change(y, u, v)` runs on every
    frame's fresh planes."""
    def make(fn):
        def wrapper(*a, **k):
            y, u, v = fn(*a, **k)
            change(y, u, v)
            return y, u, v
        return wrapper
    p = S.Patches()
    p.wrap(f"{TD}:decode_frame_device", make)
    return p


def dec_lf_skipped(config):
    p = S.Patches()
    p.wrap("libvpx_opencl_tpu_torch.ops.wavefront:loop_filter_planes",
           lambda fn: (lambda *a, **k: None))
    return p


def dec_ring_unchanged(config):
    def make(fn):
        def wrapper(self, np_args, meta):
            if meta[4] == 0:                # keyframes as before
                return fn(self, np_args, meta)
            return self._frame_device(np_args, meta)
        return wrapper
    p = S.Patches()
    p.wrap(f"{TD}:TorchDecoder._worker_dispatch", make)
    return p


def dec_half_left_out(config):
    def change(y, u, v):
        for plane in (y, u, v):
            plane[plane.shape[0] // 2:] = 0
    return _decoder_planes(change)


def dec_answer_altered(config):
    def change(y, u, v):
        y[BORDER + 1, BORDER + 1] += 1
    return _decoder_planes(change)


def enc_coarser_quantizer(config):
    def make(fn):
        def wrapper(self, cfg, *a, **k):
            cfg.cq_level = 56
            return fn(self, cfg, *a, **k)
        return wrapper
    p = S.Patches()
    p.wrap("libvpx_opencl_tpu_torch.api:CodecEncoder.__init__", make)
    return p


def _enc_speed(cpu_used):
    def control(config):
        from libvpx_opencl_tpu_torch.models.encoder import speed_features

        def make(fn):
            def wrapper(self, *a, **k):
                fn(self, *a, **k)
                self._enc.sf = speed_features(cpu_used)
            return wrapper
        p = S.Patches()
        p.wrap("libvpx_opencl_tpu_torch.api:CodecEncoder.__init__", make)
        return p
    return control


def enc_ring_unchanged(config):
    def make(fn):
        def wrapper(self, payload):
            keyframe, old = self._pending[0], self.ref_last
            fn(self, payload)
            if not keyframe:
                self.ref_last = old
        return wrapper
    p = S.Patches()
    p.wrap(f"{TE}:TorchEncoder.commit_frame", make)
    return p


def enc_half_left_out(config):
    def make(fn):
        def wrapper(self, keyframe):
            half = self.qcoeff.shape[0] // 2
            self.qcoeff[half:] = 0
            self.eobs[half:] = 0
            return fn(self, keyframe)
        return wrapper
    p = S.Patches()
    p.wrap(f"{TE}:TorchEncoder._pack", make)
    return p


def enc_answer_altered(config):
    def make(fn):
        def wrapper(self, keyframe):
            out = bytearray(fn(self, keyframe))
            out[len(out) * 3 // 4] ^= 0x10
            return bytes(out)
        return wrapper
    p = S.Patches()
    p.wrap(f"{TE}:TorchEncoder._pack", make)
    return p


FAULTS = {
    "decode": {"lf_skipped": dec_lf_skipped,
               "ring_unchanged": dec_ring_unchanged,
               "half_left_out": dec_half_left_out,
               "answer_altered": dec_answer_altered},
    "encode": {"coarser_quantizer": enc_coarser_quantizer,
               "cpu_used_1": _enc_speed(1),
               "cpu_used_5": _enc_speed(5),
               "ring_unchanged": enc_ring_unchanged,
               "half_left_out": enc_half_left_out,
               "answer_altered": enc_answer_altered},
}


def kind(config):
    return "decode" if config["check"] == "md5_frames" else "encode"


def main(argv=None):
    import argparse
    import json
    import time
    from vp8bench.harness import bench, loader
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    args = ap.parse_args(argv)
    c = bench.resolve(loader.spec(), args.workload)
    fault = FAULTS[kind(c["config"])][args.fault]
    for seed in (int(s) for s in args.seeds.split(",")):
        r = bench.run(c, seed, args.seconds, False, time.perf_counter(),
                      patch=fault)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": r["correct"],
                          "check": r["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
