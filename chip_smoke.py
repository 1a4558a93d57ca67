#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (libvpx_opencl_tpu_torch).

Run from the repository root on a machine with one CUDA card (sm_90a,
e.g. an H100) and nvcc:

    python3 chip_smoke.py

It builds the hand-written kernels from csrc/, holds each against its
plain PyTorch version, decodes tests/vectors/bench_1080p.ivf (30 frames,
1920x1080) through the port's entry point on the card with a per-frame
MD5 gate, then six more conformance streams, drives the user surface
(decoder API, reference controls, error concealment, postproc, the
tpuvpxdec CLI, ARNR and the analysis ops) against the host path, encodes
four of the decoded 1080p frames (1 key + 3 inter) through TorchEncoder
on the card with a closed-loop gate under SLICE2_SF, and the first ten
(1 key + 9 inter) at the default speed features (B_PRED and trellis on),
drives the multi-GPU drivers (sharded decode and encode, GOP-parallel
decode and encode, the batch transcoder) on virtual row shards of the
card, drives the encoder's user entry points (tpuvpxenc in four legs,
MultiResEncoder) at 1080p, and times decode, encode and the kernels. Any failure raises (exit
code != 0). It prints, in order:

  * the card's name and power limit (nvidia-smi) and the kernel build time;
  * K1 (intra wavefront) and K2 (loop-filter wavefront) vs their plain
    versions on random cases at R x C = (4,6), (3,3), (1,5), (5,1), (1,1),
    (2,1), (1,2), (2,2), (200,3) (more MB rows than the card has SMs) and
    (68,120): exact equality (tolerance 0: integer math);
  * K5 (encode wavefront) vs its plain version on random frames at 4x6,
    3x3, 1x5, 5x1 (C = 1), 2x2, 1x1 and 8x40, qindex 4, 24, 47, 48 and
    127, intra and B_PRED shares up to all-B_PRED, a random top border row
    (top_interior) on half of them, and at 8x40 two patterns of B_PRED
    runs (1-3 and 4-12 MBs long) broken by 16x16 and inter MBs: all six
    outputs exact;
  * K6 (the trellis) vs its plain version on random MBs (trellis_case) at
    Ni = 1, 31, 32, 33, 2250 and 8160 inter MBs, qindex 0, 4, 24, 63 and
    127, levels up to 2047 (cat6), all-zero and eob-16 blocks: levels and
    eobs exact;
  * the 1080p decode: MD5 of every frame; K1 and inter_recon (stages 1-2)
    launched once per frame, K2 once per frame with a filter level;
  * the six extra streams' MD5 results;
  * inter_recon (`inter_recon_phases`) against the plain inter_planes on
    every 1080p frame's inputs (residuals and inter MBs exact), its launch
    alone and inside the decoder by CUDA events, the host's enqueue time
    of it and of the plain version, the plain version's time on the card
    and the bound by bytes, for the keyframe and the mean inter frame;
  * decode fps (median of 3 timed runs after one warm-up) and each
    kernel's per-frame time from CUDA events (its launch alone on every
    decoded frame's inputs, and around the wrapper inside the decoder)
    with its launches per frame, its chain of 2(R-1)+C dependent MB steps
    and the microseconds per step, beside the card's name and power limit;
  * the user surface (`surface_phases`), each held against the port's
    host path: the 1080p stream through the API's CodecDecoder on the
    card (MD5 of every frame from get_frame(), K1 once per frame, K2 once
    per filtered frame, get_reference("last") right after decode() equal
    to the decoded frame; fps with every frame read back); a LAST
    snapshot rolled back with set_reference on inter_cif and odd_65x49;
    error concealment with input fragments on part4_cif (seed 3, 50%
    loss); postproc on inter_cif (five flag sets) and on the first three
    1080p frames with its seconds per frame; `python -m
    libvpx_opencl_tpu_torch.cli.tpuvpxdec --md5 --summary` on the 1080p
    stream as a subprocess (golden MD5s, its fps); ARNR over five 1080p
    frames and the five analysis ops on a 1080p plane, with their times;
    one altref encode through TorchEncoder on the card (ARNR handed the
    card), its payloads equal to those with ARNR on the host;
  * K3 (SAD grid) vs its plain version at N = 48, at (3,3), (1,5), (5,1),
    at rng 7 and 1, on windows at every column mod 4, on plane 0 with
    source 255 (every SAD 65280) and at 68x120 on a decoded 1080p frame:
    exact equality; ties on a constant plane resolved on the card as on
    the CPU;
  * a QCIF clip encoded under SLICE2_SF on the card and on the CPU:
    payload bytes equal;
  * the 1080p encode under SLICE2_SF: bytes, luma PSNR, K3/K2/K5/K6
    launches per frame (K3 once per reference searched, K2 and K5 once, K6
    never: the trellis is off), the payload
    decoded by TorchDecoder on the card equal to the encoder's
    reconstruction;
    full_search through K3 equal to full_search through the plain version
    on an inter frame's tensors;
  * encode frames/s over the inter frames, the keyframe's seconds, the
    encode wavefront's seconds (inter batch + K5) per frame with K5's chain
    of dependent MB steps, K3's time per launch and that of
    torch.cdist(p=1) on the same candidates (its yardstick, held equal to
    K3);
  * at the default speed features: the QCIF clip's payloads, and the
    packets of the port's CodecEncoder, equal on the card and the CPU;
  * the 1080p encode (1 key + 9 inter) at the default speed features with
    the same gates (K5 once per frame, K6 once per inter frame with inter
    MBs and never on the keyframe) and each frame's bytes equal to
    DEFAULT_BYTES: per frame its bytes beside the SLICE2_SF bytes, intra
    and B_PRED MBs, inter MBs the trellis ran on, the plain version's
    dependency levels, its seconds and K5's and K6's times by CUDA events
    in the encoder; frames/s;
    then K5 vs plain on that encode's keyframe and inter frames 1 and 3
    (all six outputs exact; the plain version's time) and K5's launch
    alone on every frame's inputs (CUDA events, median of 3, after the
    inter batch) with its chain of dependent steps (k5_chain, a model of
    the kernel's schedule on the frame's flags: 187 on the all-16x16
    keyframe, checked), its us per step and its bound;
    K6 vs plain on the trellis inputs of inter frames 1 and 2 (levels and
    eobs exact; the plain version's time) and K6's launch alone on every
    inter frame's inputs (CUDA events, median of 3, queued behind a sleep
    kernel, and from an idle card) with its bound; then a
    second encode of the first two frames timing the B_PRED decision
    candidate, the encode wavefront, K5 inside it and the trellis (K6
    through its wrapper), each synchronised, with K6's time beside the
    trellis stage's and the encode's frames/s;
  * the multi-GPU drivers on virtual row shards of the one card
    (`multi_shard_phases`): K1 and K2 with top_interior vs their plain
    versions at 17 x 120 and 3 x 5 (exact); ShardedTorchDecoder on the
    1080p stream at 2 and 4 shards with the shard-to-card map, MD5 of
    every frame and K1 once per shard per frame, and decode fps at 1, 2
    and 4 shards beside TorchDecoder (in turns, median of 3);
    decode_streams with 2 groups x 2 shards on inter_cif and part4_cif;
    ShardedTorchEncoder at 4 shards under SLICE2_SF, its payloads equal to
    the SLICE2_SF phase's, K3 once per reference per shard, K5 once per
    shard, K6 never; ShardedTorchEncoder at 2 and 4 shards under the
    default speed features with B_PRED off (the trellis on), its payloads
    equal to a single-card TorchEncoder's with the same features, K6 once
    per shard per inter frame and never on the keyframe, each payload
    decoded by TorchDecoder equal to the encoder's reconstruction;
    encode_gops at 1080p, 2 groups x 2 frames, equal to a
    sequential encode with the same keyframes, K5 once per frame, K6
    never; the BatchTranscoder on two QCIF jobs with resume (default
    features: K6 on their inter frames), equal to a sequential transcode;
  * the encoder's user entry points (`cli_encode_phases`): tpuvpxenc's
    main(..., device="cuda") on the first 6 decoded 1080p frames (written
    as a Y4M) in four legs: cq 24 at the default features (its bytes
    per frame == DEFAULT_BYTES), vbr 4000 kbps (the recode loop), two-pass
    at --cpu-used 5 (the host first pass timed apart) and --auto-alt-ref
    with lag 4 at --cpu-used 5 on 7 frames, written as WebM (an invisible
    ARF, ARNR handed the card); then MultiResEncoder(1920, 1080) on 6
    frames. Each leg's payloads == the same flow driven directly on a
    TorchEncoder, every frame TorchDecoder decodes on the card has the
    MD5 of `tpuvpxdec --golden --md5` (the host decoder, one process per
    file, side by side), luma PSNR >= 30 dB, and every encode_frame
    call's launches are what its frame predicts (K3 once per reference
    under the exhaustive search, K5 once, K2 once with a filter level,
    K6 once on an inter frame with the trellis, K1 never); MultiRes's
    layers == two directly driven TorchEncoders, closed loop on the card,
    TorchDecoder MD5s == the host decoder's, and K5 and K2 == plain on
    the 960x540 low layer's first two frames.
    Per leg: frames/s over main(), bytes, calls, launches, --psnr;
  * K4, the device detokenizer (`entropy_phases`): its main path,
    tools/bench_entropy_torch.py over all 30 frames of bench_1080p (the
    host decoder's entropy layer; K4 through its wrapper once per frame,
    equal to the host C++ detokenizer on every MB with tokens, the
    keyframe included; host C++, K4 and wrapper-with-uploads ms per
    frame); K4 vs its plain version on qcoeff, eobs, skipped and states
    (exact) on bench_1080p frames 0, 1 and 15, every frame of part4_cif
    (4 partitions) and inter_qcif, random bytes at 17 x 30 MBs in 8
    partitions and R = 2 < P = 4; each 1080p frame's launch alone by CUDA
    events, ns per dependent bool read, the bytes bound; then
    `python3 bench_torch.py` as a subprocess (BENCH_RUNS=3), its JSON line
    bit-exact, its fps beside the card's name and power limit;
  * one JSON line {"kernels": [...]} (K1-K6, inter_recon) and, last,
    {"ok": true, "device": ...}.

It imports nothing of JAX or of the JAX package.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
VECTORS = os.path.join(HERE, "tests", "vectors")
# K1 / K2 vs plain on random frames; 34 x 60 is MultiResEncoder's 960x540
# low layer, 68 x 120 the 1080p frame
GEOMS = [(4, 6), (3, 3), (1, 5), (5, 1), (1, 1), (2, 1), (1, 2), (2, 2),
         (200, 3), (34, 60), (68, 120)]
EXTRA_STREAMS = ["profile1_qcif", "profile2_qcif", "profile3_qcif",
                 "odd_65x49", "part4_cif", "seg_roi_qcif"]
# 1080p frames of the SLICE2_SF encode (1 key + 3 inter), of the
# default-feature encode (1 key + 9 inter) and of its timed split
SLICE2_FRAMES = 4
DEFAULT_FRAMES = 10
SPLIT_FRAMES = 2
# K5 vs plain on random frames: geometries (C = 1 included), qindex values
# on both sides of the zbin factor's switch at 48, and (intra share,
# B_PRED share) pairs; every other case has a random top border row
K5_GEOMS = [(4, 6), (3, 3), (1, 5), (5, 1), (2, 2), (1, 1), (8, 40)]
K5_QINDEX = [4, 24, 47, 48, 127]
K5_SHARES = [(1.0, 1.0), (0.7, 0.5), (1.0, 0.0), (0.5, 0.3)]
# K5 vs plain at 8 x 40: B_PRED runs of these lengths broken by 16x16 and
# inter MBs (encode_case's runs), at qindex 24 and 60
K5_RUNS = [(1, 3), (4, 12)]
# K5 vs plain on these frames of the default-feature 1080p encode: the
# keyframe (all 16x16), inter frame 1 and inter frame 3 (5110 B_PRED MBs)
K5_PLAIN_FRAMES = (0, 1, 3)
# K6 vs plain on random MBs: inter MB counts (a warp tile holds 32 blocks:
# 1, 31, 32 and 33 MBs end their tiles differently; 2250: a default inter
# frame's most; 8160: every MB of a 1080p frame, more tiles than the
# persistent grid has warps) and qindex values from the smallest quantizer
# to the largest
K6_NI = [1, 31, 32, 33, 2250, 8160]
K6_QINDEX = [0, 4, 24, 63, 127]
# bytes per frame of the default-feature 1080p encode of frames 0-9 at
# qindex 24: the encode is deterministic, and the trellis's levels decide
# every inter frame's bytes
DEFAULT_BYTES = [422252, 297031, 289888, 293468, 348510, 291138, 340120,
                 282933, 342811, 281112]
# tpuvpxenc legs on the first decoded 1080p frames: (name, options,
# output extension, frames); the legs with --cpu-used 5 run no trellis.
# Lag 4 puts the first ARF before frame 4, and it needs 3 frames in the
# lookahead there (models/arnr.py:encode_stream_altref): 7 frames, the
# fewest with an ARF (the host decoder's ~20 s per 1080p frame of this
# leg's file sets the phase's wall). MultiResEncoder takes CLI_FRAMES.
CLI_FRAMES = 6
# K5 and K2 vs plain on MultiResEncoder's low layer: its keyframe and first
# inter frame (K5's plain version takes seconds per frame)
MR_PLAIN_FRAMES = 2
CLI_LEGS = [
    ("cq", ["--end-usage", "cq", "--cq-level", "24", "--psnr"], ".ivf", 6),
    ("vbr", ["--end-usage", "vbr", "--target-bitrate", "4000", "--psnr"],
     ".ivf", 6),
    ("two_pass", ["--passes", "2", "--target-bitrate", "4000",
                  "--cpu-used", "5", "--psnr"], ".ivf", 6),
    ("auto_alt_ref", ["--auto-alt-ref", "1", "--lag-in-frames", "4",
                      "--end-usage", "cq", "--cpu-used", "5"], ".webm", 7),
]
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def intra_case(np, rng, R, C):
    N = R * C
    return (rng.integers(0, 256, (N, 16, 16)), rng.integers(0, 256, (N, 8, 8)),
            rng.integers(0, 256, (N, 8, 8)),
            rng.integers(-80, 80, (N, 16, 16)),
            rng.integers(-80, 80, (N, 8, 8)), rng.integers(-80, 80, (N, 8, 8)),
            rng.integers(0, 5, N), rng.integers(0, 4, N), rng.random(N) < 0.6,
            rng.integers(0, 10, (N, 16)))


def lf_case(np, rng, R, C):
    N = R * C
    flevel = rng.integers(0, 64, N)
    flevel[rng.random(N) < 0.2] = 0
    return (rng.integers(0, 256, (N, 16, 16)), rng.integers(0, 256, (N, 8, 8)),
            rng.integers(0, 256, (N, 8, 8)), flevel, 2 * (flevel + 2) + 1,
            2 * flevel + 1, np.maximum(flevel // 2, 1),
            np.clip(flevel // 16 + 1, 0, 3), rng.random(N) < 0.7)


def encode_case(np, rng, R, C, qindex, intra_share, bpred_share, with_top,
                runs=None):
    """Random inputs of the encode wavefront (numpy): flat or textured
    sources, inter predictions near them or not, modes with a share of
    B_PRED, the quantizer and RD constants of qindex (the encoder's), and
    optionally a random top border row per plane. runs: None, or (lo, hi):
    each row is then runs of lo..hi consecutive B_PRED MBs, each broken by
    one or two 16x16 or inter MBs (the shares are not used). Returns
    (args, kw) as encode_recon_planes takes them."""
    from libvpx_opencl_tpu_torch.models import rdopt
    from libvpx_opencl_tpu_torch.models.refdec import dequant_factors
    from libvpx_opencl_tpu_torch.ops import wavefront as W
    N = R * C
    flat = rng.random(N) < 0.4
    src = []
    for n in (16, 8, 8):
        base = rng.integers(20, 236, (N, 1, 1)) + rng.integers(-3, 4,
                                                               (N, n, n))
        src.append(np.where(flat[:, None, None], base,
                            rng.integers(0, 256, (N, n, n))).astype(np.int32))
    near = rng.random(N) < 0.5
    inter = [np.where(near[:, None, None],
                      np.clip(x + rng.integers(-6, 7, x.shape), 0, 255),
                      rng.integers(0, 256, x.shape)).astype(np.int32)
             for x in src]
    mode = np.where(rng.random(N) < bpred_share, W.B_PRED_M,
                    rng.integers(0, 4, N)).astype(np.int32)
    uv_mode = rng.integers(0, 4, N).astype(np.int32)
    intra = rng.random(N) < intra_share
    if runs is not None:
        kinds = []                     # per MB: 0 inter, 1 16x16, 2 B_PRED
        for _ in range(R):
            row = []
            while len(row) < C:
                row += [2] * int(rng.integers(runs[0], runs[1] + 1))
                row += [int(rng.integers(0, 2))] * int(rng.integers(1, 3))
            kinds += row[:C]
        kinds = np.asarray(kinds)
        intra = kinds > 0
        mode = np.where(kinds == 2, W.B_PRED_M, mode % W.B_PRED_M) \
            .astype(np.int32)
    dqs = [np.tile(np.asarray(d, np.int32), (N, 1))
           for d in dequant_factors(qindex, 0, 0, 0, 0, 0)]
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    args = src + inter + [mode, uv_mode, intra] + dqs + \
        [np.full(N, qindex, np.int32)]
    kw = {"bmode_cost": np.asarray(rdopt.BMODE_COST, np.int32),
          "rdmult": np.float32(rdm), "rddiv": np.float32(rdd)}
    if with_top:
        kw["top"] = [rng.integers(0, 256, shape[1]).astype(np.uint8)
                     for shape in W.plane_shapes(R, C)]
    return args, kw


def trellis_case(np, rng, ni, qindex):
    """Random inputs of the trellis (numpy) for `ni` inter MBs at qindex's
    quantizer and RD constants: levels of every size up to cat6 (|level|
    up to 2047, so |coef| up to 2047 * dq), each coefficient within one dq
    of its level times dq, both bounds included (so the one-step-toward-
    zero candidate applies about half the time), sparse blocks, all-zero
    blocks and blocks whose eob is 16; Y DC levels 0 (they travel in Y2);
    e0 the levels' eobs with Y eobs at least 1, as
    wavefront.transform_quant returns them. Returns
    (coefs, q0, e0, dq_y1, dq_y2, dq_uv, rdmult, rddiv) as trellis_mbs
    takes them."""
    from libvpx_opencl_tpu_torch.models import rdopt
    from libvpx_opencl_tpu_torch.models.refdec import dequant_factors
    from libvpx_opencl_tpu_torch.ops import tables as T
    dqs = [np.tile(np.asarray(d, np.int32), (ni, 1))
           for d in dequant_factors(qindex, 0, 0, 0, 0, 0)]
    dq = np.concatenate([np.repeat(dqs[0][:, None], 16, 1),
                         np.repeat(dqs[2][:, None], 8, 1), dqs[1][:, None]], 1)
    dqv = np.concatenate([dq[..., :1], np.repeat(dq[..., 1:], 15, -1)], -1)
    shape = (ni, 25, 16)
    size = rng.random(shape)
    lvl = np.where(size < 0.7, rng.integers(1, 4, shape),
                   np.where(size < 0.93, rng.integers(4, 67, shape),
                            rng.integers(67, 2048, shape)))
    kind = rng.random((ni, 25, 1))
    keep = np.where(kind < 0.1, False, np.where(
        kind > 0.85, True, rng.random(shape) < rng.random((ni, 25, 1))))
    q0 = np.where(keep, np.where(rng.random(shape) < 0.5, -lvl, lvl), 0)
    q0[:, :16, 0] = 0
    coefs = q0 * dqv + rng.integers(-dqv, dqv + 1)
    scan = np.asarray(T.ZIGZAG, np.int64)
    e0 = ((q0[..., scan] != 0) * np.arange(1, 17)).max(-1)
    e0[:, :16] = np.maximum(e0[:, :16], 1)
    rdm, rdd, _ = rdopt.rd_consts(qindex)
    return ([a.astype(np.int32) for a in (coefs, q0, e0)] + dqs +
            [np.float32(rdm), np.float32(rdd)])


def max_abs_diff(torch, got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def surface_phases(torch, np, card):
    """The port's user surface on the card, after the decode phases:
    CodecDecoder with MD5 gates and launch counts, the reference controls,
    error concealment with input fragments, postproc, the tpuvpxdec CLI as
    a subprocess, and ARNR with the five analysis ops, each held against
    the port's host path. Returns the K1/K2 launches of the CodecDecoder
    run (counts zeroed just before it, read just after)."""
    from libvpx_opencl_tpu_torch import api
    from libvpx_opencl_tpu_torch.models import arnr, me_host
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.ops import analysis_device as AD
    from libvpx_opencl_tpu_torch.ops import metrics
    from libvpx_opencl_tpu_torch.ops import postproc as PP
    from libvpx_opencl_tpu_torch.ops import wavefront as W
    from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
    from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s

    def host(flags=()):
        return api.CodecDecoder(flags=flags, use_device=False)

    def card_dec(flags=()):
        return api.CodecDecoder(flags=flags, device="cuda")

    def same(a, b):
        return len(a) == len(b) and all(
            np.array_equal(x, y) for fa, fb in zip(a, b)
            for x, y in zip(fa, fb))

    def take(dec, out):
        out.extend(tuple(np.array(p) for p in f) for f in dec.get_frame())

    t_start = time.perf_counter()
    path = os.path.join(VECTORS, "bench_1080p.ivf")
    golden = load_golden_md5s(path + ".md5")
    frames = read_ivf(path).frames

    # 1. CodecDecoder: every frame from get_frame() MD5-checked; K1 once
    # per frame, K2 once per filtered frame; and (2) get_reference("last")
    # right after decode(), before get_frame(), is the frame just decoded
    # whenever that frame refreshed LAST
    for name in W.launches:
        W.launches[name] = 0
    dec = card_dec()
    shown, per_frame, refs_checked = [], [], 0
    for payload, _pts in frames:
        before = dict(W.launches)
        dec.decode(payload)
        ref = dec.get_reference("last") \
            if dec.get_last_ref_updates() & 1 else None
        got = []
        take(dec, got)
        per_frame.append((
            W.launches["intra_wavefront"] - before["intra_wavefront"],
            W.launches["lf_wavefront"] - before["lf_wavefront"],
            dec._dec.filter_level))
        for planes in got:
            if len(shown) >= len(golden) or \
                    frame_md5(*planes) != golden[len(shown)]:
                fail(f"CodecDecoder bench_1080p frame {len(shown)}: MD5 "
                     f"mismatch")
            shown.append(planes)
        if ref is not None and got:
            if not same([ref], got):
                fail(f"CodecDecoder bench_1080p frame {len(shown) - 1}: "
                     f"get_reference('last') right after decode is not "
                     f"the decoded frame")
            refs_checked += 1
    api_launches = {k: W.launches[k]
                    for k in ("intra_wavefront", "lf_wavefront")}
    if len(shown) != len(golden):
        fail(f"CodecDecoder bench_1080p: {len(shown)} frames, {len(golden)} "
             f"expected")
    for i, (k1, k2, level) in enumerate(per_frame):
        if k1 != 1 or k2 != (1 if level else 0):
            fail(f"CodecDecoder bench_1080p frame {i} (filter level {level}) "
                 f"launched K1 {k1} and K2 {k2} times")
    print(f"CodecDecoder bench_1080p: {len(shown)}/{len(golden)} frames from "
          f"get_frame() MD5-exact; K1 launches {api_launches['intra_wavefront']}"
          f", K2 launches {api_launches['lf_wavefront']} (one per frame / "
          f"per filtered frame); get_reference('last') right after decode "
          f"== the frame on {refs_checked} frames that refreshed LAST",
          flush=True)

    def codec_pass():
        d = card_dec()
        for payload, _pts in frames:
            d.decode(payload)
            for _ in d.get_frame():
                pass
        torch.cuda.synchronize()

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        codec_pass()
        runs.append(time.perf_counter() - t0)
    codec_fps = len(frames) / statistics.median(runs)
    print(f"CodecDecoder bench_1080p: {codec_fps:.2f} fps with every frame "
          f"read back by get_frame() (median of 3: "
          f"{[round(r, 4) for r in runs]} s) [{card}]", flush=True)

    # 2. reference controls: snapshot LAST, decode two frames, roll LAST
    # back and decode on; card == the port's host class
    def roll(dec, name):
        fr = read_ivf(os.path.join(VECTORS, f"{name}.ivf")).frames
        out = []
        dec.decode(fr[0][0])
        take(dec, out)
        snap = dec.get_reference("last")
        for payload, _pts in fr[1:3]:
            dec.decode(payload)
            take(dec, out)
        dec.set_reference("last", snap)
        out.append(dec.get_reference("last"))
        for payload, _pts in fr[3:]:
            dec.decode(payload)
            take(dec, out)
        return out

    for name in ("inter_cif", "odd_65x49"):
        got, want = roll(card_dec(), name), roll(host(), name)
        if not same(got, want):
            fail(f"{name}: set_reference roll-back on the card differs from "
                 f"the host class")
        print(f"{name}: snapshot, 2 frames, set_reference('last') roll-back, "
              f"{len(got) - 4} more frames: card == host class", flush=True)

    # 3. error concealment with input fragments: the loss pattern of
    # examples/decode_with_partial_drops.py at seed 3, 50%
    def partial_drops(dec):
        rng = np.random.RandomState(3)
        out = []
        for payload, _pts in read_ivf(os.path.join(
                VECTORS, "part4_cif.ivf")).frames:
            cut = max(10, len(payload) // 2)
            dec.decode(payload[:cut])
            if not (payload[0] & 1) or rng.rand() * 100 >= 50:
                dec.decode(payload[cut:])
            dec.decode(None)
            fr = []
            take(dec, fr)
            out.append(([frame_md5(*f) for f in fr],
                        dec.get_frame_corrupted()))
        return out

    flags = (api.USE_INPUT_FRAGMENTS, api.USE_ERROR_CONCEALMENT)
    got, want = partial_drops(card_dec(flags)), partial_drops(host(flags))
    if got != want:
        fail("part4_cif partial drops: card differs from the host class")
    print(f"part4_cif with fragments, EC, 50% second-packet loss: card == "
          f"host class ({sum(c for _, c in got)} of {len(got)} frames "
          f"concealed)", flush=True)

    # 4. postproc: card == host class on inter_cif; on the first 3 frames
    # of the bench stream, card == ops/postproc applied to the MD5-checked
    # frames with the decoder state of another TorchDecoder
    inter = read_ivf(os.path.join(VECTORS, "inter_cif.ivf")).frames
    for pp, noise in (({"deblock", "addnoise"}, 2), ({"deblock", "mfqe"}, 0),
                      ({"debug_clr_blk_modes"}, 0),
                      ({"debug_clr_frm_ref_blks"}, 0),
                      ({"debug_draw_mv"}, 0)):
        outs = []
        for dec in (card_dec((api.USE_POSTPROC,)),
                    host((api.USE_POSTPROC,))):
            dec.set_postproc(api.PostProcCfg(flags=set(pp),
                                             noise_level=noise))
            out = []
            for payload, _pts in inter:
                dec.decode(payload)
                take(dec, out)
            outs.append(out)
        if not same(*outs):
            fail(f"postproc {sorted(pp)} on inter_cif: card differs from "
                 f"the host class")
        print(f"postproc {sorted(pp)} on inter_cif ({len(outs[0])} frames): "
              f"card == host class", flush=True)
    pp = {"deblock", "addnoise", "mfqe"}
    dec = card_dec((api.USE_POSTPROC,))
    dec.set_postproc(api.PostProcCfg(flags=pp, noise_level=2))
    state = TD.TorchDecoder(device="cuda")
    prev = qprev = None
    pp_s = []
    for k in range(3):
        dec.decode(frames[k][0])
        dec._dec._sync()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        take(dec, got)
        pp_s.append(time.perf_counter() - t0)
        state.decode_frame_core(frames[k][0])
        y, u, v = PP.post_proc_frame(*shown[k], state.base_qindex, pp, 2)
        if prev is not None and state.base_qindex - qprev >= 0:
            y, u, v = PP.mfqe_frame((y, u, v), prev, state.base_qindex, qprev,
                                    state.mode, state.mv,
                                    keyframe=state.frame_type == 0)
        prev, qprev = (y, u, v), state.base_qindex
        want = PP.debug_overlay(y, u, v, pp, mode=state.mode,
                                ref_frame=state.ref_frame, mvs=state.mv)
        if not same(got, [want]):
            fail(f"postproc {sorted(pp)} on bench_1080p frame {k}: card "
                 f"differs from ops/postproc on the MD5-checked frame")
    print(f"postproc {sorted(pp)} on bench_1080p frames 0-2: card == "
          f"ops/postproc on the MD5-checked frames; get_frame() "
          f"{[round(x, 4) for x in pp_s]} s per frame (host NumPy postproc "
          f"and readback) [{card}]", flush=True)

    # 5. the CLI twin as users run it
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "libvpx_opencl_tpu_torch.cli.tpuvpxdec",
         path, "--md5", "--summary"], cwd=HERE, capture_output=True,
        text=True, timeout=600, check=True)
    wall = time.perf_counter() - t0
    if [ln.split()[0] for ln in r.stdout.splitlines()] != golden:
        fail("tpuvpxdec --md5 on bench_1080p differs from the golden file")
    summary = r.stderr.strip().splitlines()[-1]
    print(f"tpuvpxdec bench_1080p --md5 --summary: {len(golden)} MD5 lines == "
          f"golden; '{summary}'; process wall {wall:.2f} s [{card}]",
          flush=True)

    # 6. ARNR and the five analysis ops on the card vs the host twins
    five = shown[:5]
    t0 = time.perf_counter()
    alt_dev = arnr.synthesize_altref(five, 2, device="cuda")
    arnr_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    alt_dev = arnr.synthesize_altref(five, 2, device="cuda")
    arnr_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    alt_host = arnr.synthesize_altref(five, 2)
    arnr_host = time.perf_counter() - t0
    if not same([alt_dev], [alt_host]):
        fail(f"synthesize_altref on the card differs from the host path")
    print(f"ARNR synthesize_altref over bench_1080p frames 0-4 (centre 2): "
          f"card == host on all three planes; card {arnr_dev:.4f} s (first call "
          f"{arnr_first:.4f} s), host NumPy {arnr_host:.4f} s [{card}]",
          flush=True)

    # 6b. one altref encode through TorchEncoder on the card: ARNR runs
    # where the encoder runs, and the payloads equal those of the same
    # encode with ARNR on the host NumPy path
    from libvpx_opencl_tpu_torch.models import torch_encoder as TE
    clip = [tuple(np.ascontiguousarray(p[:h, :w]) for p, h, w in zip(
        f, (144, 72, 72), (176, 88, 88))) for f in shown[:6]]
    real, seen = arnr.synthesize_altref, []

    def altref_encode(host_arnr):
        def spy(*a, device=False, **kw):
            seen.append(device)
            return real(*a, device=False if host_arnr else device, **kw)
        arnr.synthesize_altref = spy
        try:
            return arnr.encode_sequence_altref(
                TE.TorchEncoder(176, 144, qindex=40, device="cuda"), None,
                clip, gf_interval=4, max_frames=3)
        finally:
            arnr.synthesize_altref = real

    t0 = time.perf_counter()
    on_card = altref_encode(False)
    altref_s = time.perf_counter() - t0
    on_host = altref_encode(True)
    if on_card != on_host or seen[0] != torch.device("cuda"):
        fail(f"altref encode: ARNR given {seen[0]}; payloads with ARNR on "
             f"the card differ from those with ARNR on the host")
    print(f"altref encode (QCIF crops of bench_1080p frames 0-5, one "
          f"ARF): ARNR handed {seen[0]}, payloads == ARNR on the host "
          f"({[len(p) for p in on_card]} bytes, {altref_s:.3f} s) [{card}]",
          flush=True)

    def timed(fn, reps=5):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps * 1e3

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    a16, b16 = arnr._pad16(shown[2][0]), arnr._pad16(shown[1][0])
    ta, tb = up(a16), up(b16)
    ms = {}
    got, ms["fullpel_match_device"] = timed(
        lambda: AD.fullpel_match_device(ta, tb, 7))
    if not all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(
            got, me_host.fullpel_match(a16, b16, 7))):
        fail("fullpel_match_device on the card differs from "
             "me_host.fullpel_match")
    wgt = np.where(got[2].cpu().numpy() < arnr.THRESH_LOW, 2, 1) \
        .astype(np.int32).repeat(16, 0).repeat(16, 1)
    acc = np.zeros(a16.shape, np.int32)
    cnt = np.zeros(a16.shape, np.int32)
    arnr._weighted_accumulate(a16, b16, 6, wgt, acc, cnt)
    z, tw = up(np.zeros(a16.shape, np.int32)), up(wgt)
    (da, dc), ms["temporal_filter_apply_device"] = timed(
        lambda: AD.temporal_filter_apply_device(ta, tb, 6, tw, z, z))
    if not (np.array_equal(da.cpu().numpy(), acc) and
            np.array_equal(dc.cpu().numpy(), cnt)):
        fail("temporal_filter_apply_device on the card differs from "
             "arnr._weighted_accumulate")
    out, ms["temporal_filter_normalize_device"] = timed(
        lambda: AD.temporal_filter_normalize_device(da, dc, ta))
    cnt1 = np.maximum(cnt, 1)
    if not np.array_equal(out.cpu().numpy(), np.where(
            cnt > 0, (acc + (cnt1 >> 1)) // cnt1, a16).astype(np.uint8)):
        fail("temporal_filter_normalize_device on the card differs from the "
             "host normalize")
    (sse, var), ms["variance_blocks_device"] = timed(
        lambda: AD.variance_blocks_device(ta, tb))
    d = (a16.astype(np.int64) - b16.astype(np.int64)).reshape(
        a16.shape[0] // 16, 16, a16.shape[1] // 16, 16)
    s, q = d.sum((1, 3)), (d * d).sum((1, 3))
    if not (np.array_equal(sse.cpu().numpy(), q) and
            np.array_equal(var.cpu().numpy(), q - ((s * s) >> 8))):
        fail("variance_blocks_device on the card differs from the host sums")
    ya, yb = up(shown[2][0]), up(shown[1][0])
    ssim, ms["ssim_plane_device"] = timed(lambda: AD.ssim_plane_device(ya, yb))
    ssim_host = metrics.ssim_plane(shown[2][0], shown[1][0])
    if not abs(float(ssim) - ssim_host) < 1e-5:
        fail(f"ssim_plane_device {float(ssim)} on the card vs "
             f"metrics.ssim_plane {ssim_host}: |diff| >= 1e-5")
    print(f"analysis ops on bench_1080p luma {a16.shape} (frames 2 vs 1) on "
          f"the card == host twins (SSIM {float(ssim):.7f} vs {ssim_host:.7f}, "
          f"|diff| {abs(float(ssim) - ssim_host):.2e} < 1e-5); ms per call "
          f"(mean of 5, host clock to synchronize): " + ", ".join(
              f"{k} {v:.4f}" for k, v in ms.items()) + f" [{card}]",
          flush=True)
    print(f"surface phases: {time.perf_counter() - t_start:.1f} s", flush=True)
    return api_launches


def k5_to_card(torch, np, args, kw):
    """encode_case's numpy inputs as tensors on the card."""
    dev = torch.device("cuda")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    kw = dict(kw)
    kw["bmode_cost"] = up(kw["bmode_cost"])
    for k in ("rdmult", "rddiv"):
        kw[k] = torch.tensor(float(kw[k]), dtype=torch.float32, device=dev)
    if "top" in kw:
        kw["top"] = [up(row) for row in kw["top"]]
    return [up(a) for a in args], kw


def k5_chain(np, R, C, intra, bpred=None):
    """Dependent steps on K5's critical path. A block runs its row's intra
    MBs in turn (inter MBs are done before the launch): a 16x16 MB (r,c)
    is one step once row r-1 has finished min(c+1, C) MBs; a run of k
    consecutive B_PRED MBs is 4k + 6 sub-block steps, its MB m entering at
    step 4m once row r-1 has finished min(c+2, C) MBs and done after step
    4m + 9. (R-1)+C on an all-16x16 keyframe."""
    intra = np.asarray(intra, bool).reshape(R, C)
    bp = np.zeros((R, C), bool) if bpred is None else \
        np.asarray(bpred, bool).reshape(R, C) & intra
    done = np.zeros((R + 1, C), np.int64)   # last finish at or left of c
    for r in range(R):
        above = done[r]
        t, c = 0, 0
        while c < C:
            if not intra[r, c]:
                done[r + 1, c] = t
                c += 1
            elif not bp[r, c]:
                t = max(t, above[min(c, C - 1)]) + 1
                done[r + 1, c] = t
                c += 1
            else:
                e = c
                while e < C and bp[r, e]:
                    e += 1
                k = e - c
                for s in range(4 * k + 6):
                    if s % 4 == 0 and s // 4 < k:
                        t = max(t, above[min(c + s // 4 + 1, C - 1)])
                    t += 1
                    if s >= 9 and (s - 9) % 4 == 0:
                        done[r + 1, c + (s - 9) // 4] = t
                c = e
    return int(done.max())


def k5_vs_plain(torch, label, R, C, args, kw, err, plain_ms=None):
    """K5 (encode_recon_planes on the card) vs _encode_planes_plain on the
    same tensors: all six outputs exact; the plain version timed when
    plain_ms (a list) is given."""
    from libvpx_opencl_tpu_torch.models import wavefront as EW
    got = EW.encode_recon_planes(R, C, *args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = EW._encode_planes_plain(R, C, *args, **kw)
    torch.cuda.synchronize()
    if plain_ms is not None:
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    d = max_abs_diff(torch, got, want)
    err["encode_wavefront"] = max(err["encode_wavefront"], d)
    if d:
        names = ("qcoeff", "eobs", "y", "u", "v", "bmodes")
        bad = [n for n, g, w in zip(names, got, want) if not torch.equal(g, w)]
        fail(f"K5 disagrees with _encode_planes_plain at {label}: {bad}")
    return got


def k5_phases(torch, np, err):
    """K5 vs its plain version on random frames: each of K5_GEOMS at each
    of K5_QINDEX with one (intra, B_PRED) share pair in turn, every share
    pair at 8 x 40, a top border row on every other case; then the
    K5_RUNS patterns at 8 x 40."""
    t0 = time.perf_counter()
    cases = []
    for i, (R, C) in enumerate(K5_GEOMS):
        for j, q in enumerate(K5_QINDEX):
            pairs = K5_SHARES if (R, C) == (8, 40) and j == 1 else \
                [K5_SHARES[(i + j) % len(K5_SHARES)]]
            for ish, bsh in pairs:
                cases.append((R, C, q, ish, bsh, (i + j) % 2 == 0))
    for j, runs in enumerate(K5_RUNS):
        cases.append((8, 40, 24 + 36 * j, 0.0, 0.0, j == 0, runs))
    for k, (R, C, q, ish, bsh, top, *runs) in enumerate(cases):
        rng = np.random.default_rng(9000 + k)
        args, kw = k5_to_card(torch, np, *encode_case(
            np, rng, R, C, q, ish, bsh, top, *runs))
        k5_vs_plain(torch, f"{R}x{C} q{q} runs {runs}", R, C, args, kw, err)
    print(f"K5 vs plain on {len(cases)} random frames ({sorted(set(K5_GEOMS))}"
          f", qindex {K5_QINDEX}, intra / B_PRED shares {K5_SHARES}, top "
          f"border row on half of them; at 8x40 B_PRED runs of lengths "
          f"{K5_RUNS} broken by 16x16 and inter MBs): all six outputs exact, "
          f"max_abs_diff {err['encode_wavefront']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def k6_vs_plain(torch, label, args, err, plain_ms=None):
    """K6 (trellis_mbs on the card) vs trellis_mbs_plain on the same
    tensors: levels and eobs exact; the plain version timed when plain_ms
    (a list) is given."""
    from libvpx_opencl_tpu_torch.ops import rd_device as RD
    got = RD.trellis_mbs(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = RD.trellis_mbs_plain(*args)
    torch.cuda.synchronize()
    if plain_ms is not None:
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    d = max_abs_diff(torch, got, want)
    err["trellis"] = max(err["trellis"], d)
    if d:
        bad = [n for n, g, w in zip(("qcoeff", "eobs"), got, want)
               if not torch.equal(g, w)]
        fail(f"K6 disagrees with trellis_mbs_plain at {label}: {bad}")
    return got


def k6_phases(torch, np, err):
    """K6 vs its plain version on random MBs (trellis_case): each of K6_NI
    at each of K6_QINDEX."""
    from libvpx_opencl_tpu_torch.models import torch_encoder as TE
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tcb = list(TE._tcb_tables(dev)[:3])
    changed = 0
    for ni in K6_NI:
        for q in K6_QINDEX:
            case = trellis_case(np, np.random.default_rng(6000 + ni + q), ni,
                                q)
            args = [torch.from_numpy(a).to(dev) for a in case[:6]] + tcb + [
                torch.tensor(float(x), dtype=torch.float32, device=dev)
                for x in case[6:]]
            got = k6_vs_plain(torch, f"Ni {ni} q{q}", args, err)
            changed += int((got[0] != args[1]).any(-1).sum())
    print(f"K6 vs plain on random MBs (Ni {K6_NI}, qindex {K6_QINDEX}; "
          f"levels up to 2047, all-zero and eob-16 blocks): levels and eobs "
          f"exact, max_abs_diff {err['trellis']}; the trellis changed "
          f"{changed} blocks ({time.perf_counter() - t0:.1f} s)", flush=True)


def multi_shard_phases(torch, np, card, src_frames, slice2_payloads, err):
    """The multi-GPU drivers on the one card, with virtual row shards
    (parallel/mesh.py puts shard i on card i % cards): K1/K2 with
    top_interior vs plain at a shard geometry; ShardedTorchDecoder on
    bench_1080p at 2 and 4 shards (MD5 of every frame, one K1 launch per
    shard per frame, fps beside 1 shard); decode_streams with 2 groups x
    2 shards; ShardedTorchEncoder at 4 shards under SLICE2_SF (payloads
    == the single-card SLICE2_SF phase's); ShardedTorchEncoder at 2 and 4
    shards with the trellis (default features, B_PRED off; payloads == a
    single-card TorchEncoder's, K6 once per shard per inter frame, closed
    loop); encode_gops at 1080p, 2 groups
    x 2 frames (== a sequential encode with the same keyframes); the
    BatchTranscoder on two QCIF jobs with resume. Every count is zeroed
    just before a path and read just after; returns the summed launches.
    Updates err with the top_interior checks."""
    import tempfile
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.models import torch_encoder as TE
    from libvpx_opencl_tpu_torch.ops import wavefront as W
    from libvpx_opencl_tpu_torch.parallel import mesh as M
    from libvpx_opencl_tpu_torch.parallel.batch import BatchTranscoder
    from libvpx_opencl_tpu_torch.parallel.gop import (decode_streams,
                                                      encode_gops)
    from libvpx_opencl_tpu_torch.parallel.sharded_decode import \
        ShardedTorchDecoder
    from libvpx_opencl_tpu_torch.parallel.sharded_encode import \
        ShardedTorchEncoder
    from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
    from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    total = {name: 0 for name in W.launches}

    def zero():
        for name in W.launches:
            W.launches[name] = 0

    def add():
        for name, count in W.launches.items():
            total[name] += count
        return dict(W.launches)

    # 1. K1 and K2 with top_interior vs their plain versions, at a shard
    # of a 1080p frame (17 of its 68 MB rows) and a small one, with a top
    # border of random pixels
    for R, C in ((17, 120), (3, 5)):
        rng = np.random.default_rng(R * 1000 + C + 7)
        icase = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in intra_case(np, rng, R, C)]
        lcase = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in lf_case(np, rng, R, C)]
        planes = W.blocks_to_planes(R, C, *icase[:3])
        for pl, b in zip(planes, (32, 16, 16)):
            pl[:b] = torch.from_numpy(rng.integers(
                0, 256, (b, pl.shape[1])).astype(np.uint8)).to(dev)
        resid = [x.to(torch.int32).contiguous() for x in icase[3:6]]
        ip = W.pack_intra_params(*icase[6:])
        lp = W.pack_lf_params(*lcase[3:])
        for simple in (False, True):
            got = [p.clone() for p in planes]
            want = [p.clone() for p in planes]
            W.intra_recon_planes(R, C, *got, *resid, ip, top_interior=True)
            W._intra_planes_plain(R, C, *want, *resid, ip,
                                  top_interior=True)
            d1 = max_abs_diff(torch, got, want)
            W.loop_filter_planes(R, C, simple, *got, lp, top_interior=True)
            W._lf_planes_plain(R, C, simple, *want, lp, top_interior=True)
            d2 = max_abs_diff(torch, got, want)
            print(f"K1, K2 (simple={simple}) with top_interior vs plain "
                  f"{R}x{C}: max_abs_diff {d1}, {d2}", flush=True)
            err["intra_wavefront"] = max(err["intra_wavefront"], d1)
            err["lf_wavefront"] = max(err["lf_wavefront"], d2)
            if d1 or d2:
                fail(f"K1/K2 with top_interior disagree with plain at "
                     f"{R}x{C}")

    # 2. ShardedTorchDecoder on bench_1080p at 2 and 4 shards
    bench = os.path.join(VECTORS, "bench_1080p.ivf")
    golden = load_golden_md5s(bench + ".md5")
    frames = read_ivf(bench).frames
    for n in (2, 4):
        mesh = M.make_row_mesh(n)
        print(f"ShardedTorchDecoder {n} shards: {M.shard_map_line(mesh)}",
              flush=True)
        zero()
        dec = ShardedTorchDecoder(mesh=mesh)
        shown, per_frame = [], []
        for payload, _pts in frames:
            before = dict(W.launches)
            show, planes = dec.decode_frame(payload)
            per_frame.append((
                W.launches["intra_wavefront"] - before["intra_wavefront"],
                W.launches["lf_wavefront"] - before["lf_wavefront"],
                dec.filter_level))
            if show:
                if len(shown) >= len(golden) or \
                        frame_md5(*planes) != golden[len(shown)]:
                    fail(f"ShardedTorchDecoder {n} shards: bench_1080p "
                         f"frame {len(shown)} MD5 mismatch")
                shown.append(1)
        got = add()
        rows = [r1 - r0 for r0, r1 in dec.rows]
        if len(shown) != len(golden):
            fail(f"ShardedTorchDecoder {n} shards: {len(shown)} frames")
        for i, (k1, k2, level) in enumerate(per_frame):
            if k1 != len(rows) or k2 != (len(rows) if level else 0):
                fail(f"ShardedTorchDecoder {n} shards frame {i}: K1 {k1}, "
                     f"K2 {k2} launches for {len(rows)} shards")
        print(f"ShardedTorchDecoder {n} shards (MB rows {rows}): "
              f"{len(shown)}/{len(golden)} bench_1080p frames MD5-exact; "
              f"K1 launches {got['intra_wavefront']}, K2 launches "
              f"{got['lf_wavefront']} (one per shard per frame)", flush=True)

    def decode_all(n):
        dec = ShardedTorchDecoder(mesh=M.make_row_mesh(n)) if n else \
            TD.TorchDecoder(device="cuda")
        for payload, _pts in frames:
            dec.decode_frame_core(payload)
        dec._sync()
        torch.cuda.synchronize()

    fps = {}
    for n in (0, 1, 2, 4):
        decode_all(n)
    for rep in range(3):
        for n in (0, 1, 2, 4):
            t0 = time.perf_counter()
            decode_all(n)
            fps.setdefault(n, []).append(time.perf_counter() - t0)
    for n, runs in fps.items():
        print(f"decode bench_1080p "
              f"{'TorchDecoder' if not n else f'ShardedTorchDecoder {n} shards'}"
              f": {len(frames) / statistics.median(runs):.2f} fps (median of "
              f"3 turns: {[round(r, 4) for r in runs]} s) [{card}]",
              flush=True)

    # 3. decode_streams: 2 gop groups x 2 row shards, two streams
    names = ["inter_cif", "part4_cif"]
    streams = [[p for p, _ in read_ivf(os.path.join(
        VECTORS, f"{name}.ivf")).frames] for name in names]
    mesh = M.make_mesh(4, gop=2)
    zero()
    results = decode_streams(streams, n_devices=4, gop=2)
    got = add()
    for name, out in zip(names, results):
        gold = load_golden_md5s(os.path.join(VECTORS, f"{name}.ivf.md5"))
        if [frame_md5(*f) for f in out] != gold:
            fail(f"decode_streams: {name} MD5 mismatch")
    print(f"decode_streams {names}, 2 gop groups x 2 row shards "
          f"({M.shard_map_line(mesh)}): MD5-exact; K1 launches "
          f"{got['intra_wavefront']}", flush=True)

    # 4. ShardedTorchEncoder, 4 shards, SLICE2_SF, the SLICE2_SF frames
    zero()
    enc = ShardedTorchEncoder(1920, 1080, qindex=24, n_devices=4)
    enc.sf = TE.SLICE2_SF
    secs, k3, want_k3, k5 = [], [], [], []
    for i, frame in enumerate(src_frames):
        refs = 1 + (enc.ref_gold is not enc.ref_last) + (
            enc.ref_alt is not enc.ref_last and enc.ref_alt is not enc.ref_gold)
        want_k3.append(refs * len(enc.rows) if i else 0)
        before = dict(W.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = enc.encode_frame(*frame)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        k3.append(W.launches["sad_grid"] - before["sad_grid"])
        k5.append(W.launches["encode_wavefront"]
                  - before["encode_wavefront"])
        if W.launches["trellis"] != before["trellis"]:
            fail(f"ShardedTorchEncoder frame {i}: K6 launched under "
                 f"SLICE2_SF (trellis off)")
        if payload != slice2_payloads[i]:
            fail(f"ShardedTorchEncoder 4 shards frame {i}: payload differs "
                 f"from the single-card SLICE2_SF encode")
    got = add()
    per = len(enc.rows) * len(src_frames)
    if k3 != want_k3 or got["lf_wavefront"] != per or k5 != \
            [len(enc.rows)] * len(src_frames):
        fail(f"ShardedTorchEncoder: K3 launches per frame {k3}, K2 "
             f"{got['lf_wavefront']}, K5 per frame {k5}")
    print(f"ShardedTorchEncoder 4 shards (MB rows "
          f"{[r1 - r0 for r0, r1 in enc.rows]}) under SLICE2_SF: "
          f"{len(src_frames)} 1080p payloads == the single-card encode's; "
          f"K3 launches per frame {k3} (one per reference per shard), K2 "
          f"launches {got['lf_wavefront']}, K5 launches per frame {k5} (one "
          f"per shard); seconds per frame {[round(x, 3) for x in secs]} "
          f"[{card}]", flush=True)

    # 4b. ShardedTorchEncoder with the trellis: 2 and 4 shards, default
    # speed features with B_PRED off, == a single-card TorchEncoder with
    # the same features; K6 once per shard per inter frame; closed loop
    from dataclasses import replace
    ref = TE.TorchEncoder(1920, 1080, qindex=24, device="cuda")
    ref.sf = replace(ref.sf, bpred=False)
    want = [ref.encode_frame(*f) for f in src_frames]
    for n in (2, 4):
        zero()
        enc = ShardedTorchEncoder(1920, 1080, qindex=24, n_devices=n)
        if enc.sf != ref.sf:
            fail(f"ShardedTorchEncoder's speed features {enc.sf} are not the "
                 f"default ones with B_PRED off")
        dec = TD.TorchDecoder(device="cuda")
        secs, k6 = [], []
        for i, frame in enumerate(src_frames):
            before = W.launches["trellis"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = enc.encode_frame(*frame)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            k6.append(W.launches["trellis"] - before)
            if payload != want[i]:
                fail(f"ShardedTorchEncoder {n} shards with the trellis frame "
                     f"{i}: payload differs from the single-card encode")
            show, planes = dec.decode_frame(payload)
            recon = enc.ref_last.visible()
            if not show or any(not np.array_equal(a, b)
                               for a, b in zip(planes, recon)):
                fail(f"ShardedTorchEncoder {n} shards with the trellis frame "
                     f"{i}: the decoded payload differs from the encoder's "
                     f"reconstruction")
        got = add()
        if k6 != [0] + [len(enc.rows)] * (len(src_frames) - 1) or \
                got["encode_wavefront"] != len(enc.rows) * len(src_frames):
            fail(f"ShardedTorchEncoder {n} shards with the trellis: K6 "
                 f"launches per frame {k6}, K5 {got['encode_wavefront']}")
        print(f"ShardedTorchEncoder {n} shards (MB rows "
              f"{[r1 - r0 for r0, r1 in enc.rows]}) with the trellis "
              f"(default features, B_PRED off): {len(src_frames)} 1080p "
              f"payloads == the single-card encode's "
              f"({[len(p) for p in want]} bytes), decoded == the encoder's "
              f"reconstruction; K6 launches per frame {k6} (one per shard "
              f"per inter frame), K5 launches {got['encode_wavefront']}; "
              f"seconds per frame {[round(x, 3) for x in secs]} [{card}]",
              flush=True)

    # 5. encode_gops at 1080p: 2 groups x 2 frames vs sequential
    zero()
    t0 = time.perf_counter()
    par = encode_gops(src_frames, 1920, 1080, 2, qindex=24, sf=TE.SLICE2_SF)
    torch.cuda.synchronize()
    gop_s = time.perf_counter() - t0
    got = add()
    seq_enc = TE.TorchEncoder(1920, 1080, qindex=24, device="cuda")
    seq_enc.sf = TE.SLICE2_SF
    t0 = time.perf_counter()
    seq = [seq_enc.encode_frame(*f, keyframe=(i % 2 == 0))
           for i, f in enumerate(src_frames)]
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    if par != seq:
        fail("encode_gops at 1080p differs from the sequential encode with "
             "the same keyframes")
    if got["encode_wavefront"] != len(src_frames) or got["trellis"]:
        fail(f"encode_gops: K5 launched {got['encode_wavefront']} times for "
             f"{len(src_frames)} frames, K6 {got['trellis']} times under "
             f"SLICE2_SF")
    print(f"encode_gops 1080p, 2 groups x 2 frames under SLICE2_SF: == "
          f"sequential ({[len(p) for p in par]} bytes); {gop_s:.3f} s on 2 "
          f"threads vs {seq_s:.3f} s sequential; K3 launches "
          f"{got['sad_grid']}, K5 launches {got['encode_wavefront']} "
          f"[{card}]", flush=True)

    # 6. BatchTranscoder on the card: two QCIF jobs, then resume
    jobs = [os.path.join(VECTORS, f"{n}.ivf") for n in ("kf_qcif",
                                                         "lowrate_qcif")]
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        zero()
        state = BatchTranscoder(jobs, tmp, qindex=40).run()
        got = add()
        n_enc = sum(v["frames"] for v in state["stats"].values())
        if got["encode_wavefront"] != n_enc:
            fail(f"BatchTranscoder: K5 launched {got['encode_wavefront']} "
                 f"times for {n_enc} encoded frames")
        before = json.dumps(state, sort_keys=True)
        again = BatchTranscoder(jobs, tmp, qindex=40).run()
        if json.dumps(again, sort_keys=True) != before:
            fail("BatchTranscoder resume changed the checkpoint")
        for job in jobs:
            src = read_ivf(job)
            dec = TD.TorchDecoder(device="cuda")
            enc = TE.TorchEncoder(src.width, src.height, qindex=40,
                                  device="cuda")
            want = [enc.encode_frame(*dec.frame_to_show.visible())
                    for payload, _pts in src.frames
                    if dec.decode_frame_core(payload)]
            out = read_ivf(os.path.join(tmp, os.path.basename(job)))
            if [p for p, _ in out.frames] != want:
                fail(f"BatchTranscoder {os.path.basename(job)} differs from "
                     f"a sequential TorchDecoder + TorchEncoder transcode")
    print(f"BatchTranscoder on the card, 2 QCIF jobs: == sequential "
          f"transcode; resume leaves the checkpoint as it was "
          f"(frames per job: "
          f"{[v['frames'] for v in state['stats'].values()]}, K5 launches "
          f"{got['encode_wavefront']}, K6 launches {got['trellis']})",
          flush=True)
    print(f"multi-shard phases: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return total


def cli_encode_phases(torch, np, card, src_frames, err):
    """The encoder's user entry points on the card at 1080p: tpuvpxenc's
    main(..., device="cuda") in the CLI_LEGS legs on the first 6 or 7
    decoded frames of bench_1080p (written as a Y4M), then
    MultiResEncoder(1920, 1080, device="cuda") on the first CLI_FRAMES. Per leg: its bytes equal
    the same flow driven directly on a TorchEncoder; every frame that
    TorchDecoder decodes on the card has the MD5 of the host decoder's
    decode of the same file (`tpuvpxdec --golden --md5`, one process per
    file, run side by side: the host decoder takes seconds per 1080p
    frame); each shown frame's luma PSNR against its source >= 30 dB;
    the launches of every encode_frame call (recode attempts included)
    are those its frame predicts: K3 once per reference searched on an
    inter frame under the exhaustive search (--cpu-used 0; the step-2
    search of --cpu-used 1+ runs as torch ops, ops/me.py:full_search),
    K5 once, K2 once when the filter level is above 0, K6 once on an
    inter frame with the trellis on and an inter MB, K1 never. The
    altref leg writes an invisible frame and hands ARNR the card.
    MultiResEncoder's layers equal two directly driven TorchEncoders, K5
    and K2 equal their plain versions on the low layer's (34 x 60 MBs)
    first MR_PLAIN_FRAMES frames in that direct run, and both layers'
    TorchDecoder MD5s equal the host decoder's. Every count is zeroed just
    before a path and read just after; returns the summed launches."""
    import contextlib
    import io
    import tempfile
    from libvpx_opencl_tpu_torch.cli import tpuvpxenc
    from libvpx_opencl_tpu_torch.models import arnr, twopass
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.models import torch_encoder as TE
    from libvpx_opencl_tpu_torch.models import wavefront as EW
    from libvpx_opencl_tpu_torch.models.multires import (MultiResEncoder,
                                                         downsample2)
    from libvpx_opencl_tpu_torch.models.ratecontrol import (
        RateController, encode_frame_with_rc)
    from libvpx_opencl_tpu_torch.models.refdec import INTRA_FRAME
    from libvpx_opencl_tpu_torch.ops import wavefront as W
    from libvpx_opencl_tpu_torch.utils.ivf import (IvfStream, read_ivf,
                                                   write_ivf)
    from libvpx_opencl_tpu_torch.utils.md5 import frame_md5
    from libvpx_opencl_tpu_torch.utils.webm import read_webm
    from libvpx_opencl_tpu_torch.utils.y4m import Y4MReader, write_y4m

    t_start = time.perf_counter()
    frames = src_frames[:CLI_FRAMES]
    h, w = frames[0][0].shape
    total = {name: 0 for name in W.launches}
    real_encode, real_first, real_arnr = (
        TE.TorchEncoder.encode_frame, twopass.first_pass,
        arnr.synthesize_altref)
    calls, first_s, arnr_devices = [], [], []

    def refs_searched(enc):
        if not enc.sf.multi_ref:
            return 1
        return 1 + (enc.ref_gold is not enc.ref_last) + (
            enc.ref_alt is not enc.ref_last
            and enc.ref_alt is not enc.ref_gold)

    def counted_encode(self, y, u, v, keyframe=None, **kw):
        key = self.frame_count == 0 if keyframe is None else bool(keyframe)
        want = {name: 0 for name in W.launches}
        if not key and self.sf.exhaustive_me:
            want["sad_grid"] = refs_searched(self)
        before = dict(W.launches)
        payload = real_encode(self, y, u, v, keyframe=keyframe, **kw)
        n_inter = int((self.reff[1:, 1:] != INTRA_FRAME).sum())
        want["encode_wavefront"] = 1
        want["lf_wavefront"] = int(self.filter_level > 0)
        want["trellis"] = int(not key and bool(self.sf.trellis)
                              and n_inter > 0)
        calls.append(({k: W.launches[k] - before[k] for k in W.launches},
                      want))
        return payload

    def timed_first_pass(*a, **kw):
        t0 = time.perf_counter()
        out = real_first(*a, **kw)
        first_s.append(time.perf_counter() - t0)
        return out

    def arnr_spy(*a, device=False, **kw):
        arnr_devices.append(device)
        return real_arnr(*a, device=device, **kw)

    @contextlib.contextmanager
    def counted():
        """Zero the counts and record each encode_frame call's launches,
        the first pass's seconds and ARNR's device; on exit, restore and
        fill the yielded dict with the counts read just after the run."""
        got = {}
        calls.clear()
        first_s.clear()
        arnr_devices.clear()
        for name in W.launches:
            W.launches[name] = 0
        TE.TorchEncoder.encode_frame = counted_encode
        twopass.first_pass = timed_first_pass
        arnr.synthesize_altref = arnr_spy
        try:
            yield got
        finally:
            TE.TorchEncoder.encode_frame = real_encode
            twopass.first_pass = real_first
            arnr.synthesize_altref = real_arnr
        got.update(W.launches)
        for name in total:
            total[name] += got[name]

    def check_calls(label, got, k3, k6):
        """The leg's counts equal the sum of its calls' predictions, and
        each call launched what its frame predicts."""
        for i, (g, want) in enumerate(calls):
            if g != want:
                fail(f"{label}: encode_frame call {i} launched {g}, its "
                     f"frame predicts {want}")
        want = {name: sum(c[1][name] for c in calls) for name in got}
        if got != want:
            fail(f"{label}: launches {got} over the leg, {want} predicted")
        if not (got["encode_wavefront"] and got["lf_wavefront"]) or \
                bool(got["sad_grid"]) != k3 or bool(got["trellis"]) != k6:
            fail(f"{label}: launches {got}; K3 expected "
                 f"{'> 0' if k3 else '0'}, K6 {'> 0' if k6 else '0'}")

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return 10 * np.log10(255 ** 2 / mse) if mse > 0 else 99.0

    def payloads_of(path):
        if path.endswith(".webm"):
            return [(p, None) for p, _ts, _key in read_webm(path).frames]
        return read_ivf(path).frames

    def card_decode(payloads):
        """TorchDecoder on the card: the MD5 and the planes of each shown
        frame (its launches are a check and are not counted)."""
        dec = TD.TorchDecoder(device="cuda")
        shown = []
        for p in payloads:
            show, planes = dec.decode_frame(p)
            if show:
                shown.append((frame_md5(*planes), planes))
        return shown

    def direct(leg, y4m, frames):
        """The leg's flow driven directly on a TorchEncoder, as tpuvpxenc
        drives it (its defaults: --kf-max-dist 128, --min-q 4, --max-q
        63, --lag-in-frames read as lag 4, --arnr-maxframes 5,
        --arnr-strength 6). Only the cq leg's bytes are pinned
        (DEFAULT_BYTES); for the others this second encode on fresh
        device state is what shows, at 1080p on the card, that the CLI
        leaves the library's flow as it is and that the kernels give the
        same bytes run to run (a race in K2, K5 or K6 would not)."""
        rd = Y4MReader(y4m)
        fps = rd.fps[0] / max(1, rd.fps[1])
        mb = ((h + 15) // 16) * ((w + 15) // 16)
        if leg == "cq":
            enc = TE.TorchEncoder(w, h, qindex=24, device="cuda")
            return [enc.encode_frame(*f, keyframe=i == 0)
                    for i, f in enumerate(frames)]
        if leg == "vbr":
            enc = TE.TorchEncoder(w, h, qindex=24, device="cuda")
            rc = RateController(4000, fps, mb, min_q=4, max_q=63,
                                end_usage="vbr", kf_max_dist=128)
            out = []
            for i, f in enumerate(frames):
                key = i == 0 or rc.want_keyframe()
                out.append(encode_frame_with_rc(enc, rc, *f, keyframe=key))
            return [p for p in out if p]
        if leg == "two_pass":
            enc = TE.TorchEncoder(w, h, qindex=24, cpu_used=5,
                                  device="cuda")
            rc = twopass.TwoPassController(twopass.first_pass(frames), 4000,
                                           fps, mb, min_q=4, max_q=63)
            out = []
            for i, f in enumerate(frames):
                key = i == 0 or rc.want_keyframe()
                enc.qindex = rc.frame_q(key)
                p = enc.encode_frame(*f, keyframe=key)
                rc.update(enc.qindex, len(p) * 8, key)
                out.append(p)
            return [p for p in out if p]
        enc = TE.TorchEncoder(w, h, qindex=24, cpu_used=5, device="cuda")
        return [p for p in arnr.encode_stream_altref(
            enc, None, frames, lag=4, gf_interval=4, max_frames=5,
            strength=6) if p]

    host_procs, results = {}, {}
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        # -- the four legs, each timed alone (host decodes start after) --
        for leg, opts, ext, n in CLI_LEGS:
            y4m = os.path.join(tmp, f"bench_1080p_{n}.y4m")
            if not os.path.exists(y4m):
                write_y4m(y4m, src_frames[:n], w, h)
            out = os.path.join(tmp, leg + ext)
            err_text = io.StringIO()
            with counted() as got:
                with contextlib.redirect_stderr(err_text):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rc = tpuvpxenc.main([y4m, "-o", out, *opts],
                                        device="cuda")
                    wall = time.perf_counter() - t0
            if rc != 0:
                fail(f"tpuvpxenc {leg}: exit {rc}")
            check_calls(f"tpuvpxenc {leg}", got, k3="--cpu-used" not in opts,
                        k6=leg in ("cq", "vbr"))
            sizes = [len(p) for p, _ in payloads_of(out)]
            if leg == "cq" and sizes != DEFAULT_BYTES[:n]:
                # cq 24 at the default features is the default-feature
                # encode's configuration
                fail(f"tpuvpxenc cq: {sizes} bytes per frame, "
                     f"{DEFAULT_BYTES[:n]} expected")
            text = err_text.getvalue()
            psnr_line = [ln for ln in text.splitlines()
                         if "Overall PSNR" in ln]
            results[leg] = dict(out=out, y4m=y4m, n=n, wall=wall, got=got,
                                attempts=len(calls),
                                first_s=sum(first_s),
                                arnr=list(arnr_devices),
                                psnr=psnr_line[0].split(":")[1].strip()
                                if psnr_line else "not asked")
        # -- MultiResEncoder at 1920 x 1080 (+ 960 x 540) -----------------
        with counted() as mr_got:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mr = MultiResEncoder(w, h, device="cuda")
            mr_out, mr_shown = [], []
            for i, f in enumerate(frames):
                mr_out.append(mr.encode_frame(*f, keyframe=i == 0))
                mr_shown.append((mr.hi.frame_to_show, mr.lo.frame_to_show))
            mr_wall = time.perf_counter() - t0
        mr_recon = [(a.visible(), b.visible()) for a, b in mr_shown]
        check_calls("MultiResEncoder", mr_got, k3=True, k6=True)
        if mr_got["encode_wavefront"] != 2 * len(frames):
            fail(f"MultiResEncoder: K5 launched "
                 f"{mr_got['encode_wavefront']} times for "
                 f"{2 * len(frames)} layer frames")
        host_files = {leg: r["out"] for leg, r in results.items()}
        for layer, name in ((0, "hi"), (1, "lo")):
            lw, lh = (w, h) if layer == 0 else (w // 2, h // 2)
            stream = IvfStream(width=lw, height=lh, timebase_num=1,
                               timebase_den=30)
            stream.frames = [(p[layer], i) for i, p in enumerate(mr_out)]
            host_files[f"MultiResEncoder {name}"] = os.path.join(
                tmp, f"multires_{name}.ivf")
            write_ivf(host_files[f"MultiResEncoder {name}"], stream)
        card_md5 = {}
        # -- the host decoder's MD5s, one process per file ---------------
        try:
            for label, path in host_files.items():
                host_procs[label] = subprocess.Popen(
                    [sys.executable, "-m",
                     "libvpx_opencl_tpu_torch.cli.tpuvpxdec", path,
                     "--md5", "--golden"], cwd=HERE, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
            t_host = time.perf_counter()
            # -- meanwhile: the direct flows and the card's decodes ------
            for leg, opts, ext, n in CLI_LEGS:
                r = results[leg]
                payloads = [p for p, _ in payloads_of(r["out"])]
                if payloads != direct(leg, r["y4m"], src_frames[:n]):
                    fail(f"tpuvpxenc {leg}: the written payloads differ "
                         f"from the same flow driven on a TorchEncoder")
                if leg == "auto_alt_ref":
                    if all((p[0] >> 4) & 1 for p in payloads):
                        fail("tpuvpxenc auto_alt_ref wrote no invisible "
                             "altref frame")
                    if not r["arnr"] or any(d != torch.device("cuda")
                                            for d in r["arnr"]):
                        fail(f"tpuvpxenc auto_alt_ref: ARNR handed "
                             f"{r['arnr']}, not the card")
                shown = card_decode(payloads)
                if ext == ".ivf":
                    # IVF pts = source index (a dropped frame is not
                    # written)
                    src_idx = [pts for _, pts in payloads_of(r["out"])]
                else:
                    src_idx = list(range(n))
                if len(shown) != len(src_idx):
                    fail(f"tpuvpxenc {leg}: TorchDecoder showed "
                         f"{len(shown)} frames, {len(src_idx)} expected")
                r["psnr_min"] = min(psnr(src_frames[i][0], planes[0])
                                    for i, (_, planes) in zip(src_idx,
                                                              shown))
                card_md5[leg] = [m for m, _ in shown]
                r["payloads"] = payloads
                if r["psnr_min"] < 30.0:
                    fail(f"tpuvpxenc {leg}: luma PSNR {r['psnr_min']:.2f} "
                         f"dB < 30 dB")
            # MultiResEncoder: each layer == a directly driven
            # TorchEncoder, whose low layer's first MR_PLAIN_FRAMES frames
            # also hold K5 and K2 against their plain versions; decoded
            # closed-loop on the card
            real_k5, real_k2 = EW.encode_recon_planes, W.loop_filter_planes
            plain_s = []

            def k5_checked(R, C, *a):
                got = real_k5(R, C, *a)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = EW._encode_planes_plain(R, C, *a)
                torch.cuda.synchronize()
                plain_s.append(time.perf_counter() - t0)
                d = max_abs_diff(torch, got, want)
                err["encode_wavefront"] = max(err["encode_wavefront"], d)
                if d:
                    fail(f"K5 disagrees with _encode_planes_plain on "
                         f"MultiResEncoder's low layer ({R}x{C})")
                return got

            def k2_checked(R, C, simple, y, u, v, params, *a):
                want = [p.clone() for p in (y, u, v)]
                real_k2(R, C, simple, y, u, v, params, *a)
                W._lf_planes_plain(R, C, simple, *want, params, *a)
                d = max_abs_diff(torch, (y, u, v), want)
                err["lf_wavefront"] = max(err["lf_wavefront"], d)
                if d:
                    fail(f"K2 disagrees with _lf_planes_plain on "
                         f"MultiResEncoder's low layer ({R}x{C})")

            hi = TE.TorchEncoder(w, h, qindex=32, device="cuda")
            lo = TE.TorchEncoder(w // 2, h // 2, qindex=28, device="cuda")
            n_k5, n_k2 = 0, 0
            for i, f in enumerate(frames):
                if i < MR_PLAIN_FRAMES:
                    EW.encode_recon_planes = k5_checked
                    W.loop_filter_planes = k2_checked
                try:
                    before = dict(W.launches)
                    want_lo = lo.encode_frame(*(downsample2(p) for p in f),
                                              keyframe=i == 0)
                finally:
                    EW.encode_recon_planes = real_k5
                    W.loop_filter_planes = real_k2
                if i < MR_PLAIN_FRAMES:
                    n_k5 += W.launches["encode_wavefront"] - \
                        before["encode_wavefront"]
                    n_k2 += W.launches["lf_wavefront"] - \
                        before["lf_wavefront"]
                want_hi = hi.encode_frame(*f, keyframe=i == 0)
                if mr_out[i] != (want_hi, want_lo):
                    fail(f"MultiResEncoder frame {i}: a layer differs from "
                         f"a directly driven TorchEncoder")
            if n_k5 != MR_PLAIN_FRAMES or n_k2 != MR_PLAIN_FRAMES:
                fail(f"MultiResEncoder's low layer: {n_k5} K5 and {n_k2} "
                     f"K2 launches held against plain, "
                     f"{MR_PLAIN_FRAMES} each expected")
            print(f"K5 and K2 vs plain on MultiResEncoder's low layer "
                  f"({lo.R}x{lo.C} MBs, frames 0-{MR_PLAIN_FRAMES - 1}): "
                  f"exact; K5 plain {[round(s, 3) for s in plain_s]} s "
                  f"[{card}]", flush=True)
            for layer, name in ((0, "hi"), (1, "lo")):
                shown = card_decode([p[layer] for p in mr_out])
                if len(shown) != len(frames) or any(
                        not np.array_equal(a, b)
                        for (_, planes), rec in zip(shown, mr_recon)
                        for a, b in zip(planes, rec[layer])):
                    fail(f"MultiResEncoder {name} layer: TorchDecoder's "
                         f"frames differ from the encoder's reconstruction")
                card_md5[f"MultiResEncoder {name}"] = [m for m, _ in shown]
            t_wait = time.perf_counter()
            for label, proc in host_procs.items():
                out_text, err_text = proc.communicate(timeout=900)
                if proc.returncode != 0:
                    fail(f"tpuvpxdec --golden on {label}: exit "
                         f"{proc.returncode}: {err_text[-400:]}")
                host = [ln.split()[0] for ln in out_text.splitlines()]
                if host != card_md5[label]:
                    fail(f"{label}: TorchDecoder's MD5s differ from the "
                         f"host decoder's ({len(host)} host frames)")
            host_s = time.perf_counter() - t_host
            waited = time.perf_counter() - t_wait
        finally:
            for proc in host_procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for leg, opts, ext, n in CLI_LEGS:
        r = results[leg]
        enc_s = r["wall"] - r["first_s"]
        print(f"tpuvpxenc {leg} ({' '.join(opts)}, {ext}) on {n} 1080p "
              f"frames: {len(r['payloads'])} payloads, "
              f"{sum(len(p) for p in r['payloads'])} bytes, "
              f"{n / r['wall']:.4f} frames/s over main() "
              f"({r['wall']:.4f} s"
              + (f", of it the host first pass {r['first_s']:.4f} s, "
                 f"{n / enc_s:.4f} frames/s without it"
                 if r["first_s"] else "")
              + f"), {r['attempts']} encode_frame calls, launches "
              f"K3 {r['got']['sad_grid']} K5 {r['got']['encode_wavefront']}"
              f" K2 {r['got']['lf_wavefront']} K6 {r['got']['trellis']} "
              f"K1 {r['got']['intra_wavefront']}, --psnr {r['psnr']}, "
              f"min luma PSNR {r['psnr_min']:.2f} dB"
              + (f", ARNR on {r['arnr'][0]} ({len(r['arnr'])} altrefs)"
                 if r["arnr"] else "")
              + f"; payloads == the direct TorchEncoder flow, "
              f"TorchDecoder MD5s == host decoder [{card}]", flush=True)
    print(f"MultiResEncoder({w}, {h}, device='cuda') on {len(frames)} "
          f"frames: {len(frames) / mr_wall:.4f} frames/s "
          f"({mr_wall:.4f} s, both layers), hi "
          f"{sum(len(p[0]) for p in mr_out)} bytes, lo "
          f"{sum(len(p[1]) for p in mr_out)} bytes, launches K3 "
          f"{mr_got['sad_grid']} K5 {mr_got['encode_wavefront']} K2 "
          f"{mr_got['lf_wavefront']} K6 {mr_got['trellis']}; both layers == "
          f"directly driven TorchEncoders, closed loop on the card, "
          f"TorchDecoder MD5s == host decoder [{card}]", flush=True)
    print(f"CLI encode phases: {time.perf_counter() - t_start:.1f} s, of it "
          f"{host_s:.1f} s from the host decodes' start to their end "
          f"({waited:.1f} s waited after the card's checks) [{card}]",
          flush=True)
    return total


def entropy_phases(torch, np, card):
    """K4, the device detokenizer, on the card (after the other phases).
    The main path: tools/bench_entropy_torch.py over all 30 frames of
    bench_1080p (the host decoder's entropy layer, K4 through its wrapper
    on every frame, equal to the host C++ detokenizer on every MB that
    carries tokens, the keyframe included), counts zeroed just before and
    read just after. Then K4 against its plain version on every output
    (bench_1080p frames 0, 1 and 15, every frame of part4_cif and
    inter_qcif, random bytes at 17 x 30 MBs in 8 partitions, R < P), each
    1080p frame's launch alone by CUDA events, and `bench_torch.py` as a
    subprocess. Returns (K4's main-path launches, its `kernels` entry)."""
    import importlib.util
    from libvpx_opencl_tpu_torch.ops import entropy_device as ED

    spec = importlib.util.spec_from_file_location(
        "bench_entropy_torch", os.path.join(HERE, "tools",
                                            "bench_entropy_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    bench = os.path.join(VECTORS, "bench_1080p.ivf")
    n_frames = len(tool.read_ivf(bench).frames)

    for name in ED.launches:
        ED.launches[name] = 0
    dec = tool.measure(bench, n_frames, "cuda", keep=range(n_frames))
    count = ED.launches["detokenize"]
    summary = tool.report(bench, dec)
    if count != n_frames + 1 or len(dec.rows) != n_frames:
        fail(f"K4: {count} launches over {len(dec.rows)} of {n_frames} "
             "frames; one per frame and one untimed first call is the "
             "design")
    print(f"K4 on bench_1080p: {n_frames}/{n_frames} frames equal to the "
          f"host C++ detokenizer on every MB with tokens, {count} launches "
          "(one per frame, one untimed first call)", flush=True)

    err = 0
    plain_ms, reads = {}, {}

    def k4_vs_plain(label, R, C, P, arrays):
        nonlocal err
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        t0 = time.perf_counter()
        want = ED.detokenize_frame_plain(R, C, P, *cpu)
        ms = (time.perf_counter() - t0) * 1e3
        got = ED.detokenize_frame_device(R, C, P, *(t.to(dev) for t in cpu))
        torch.cuda.synchronize()
        got = [g.cpu() for g in got]
        d = max_abs_diff(torch, got, want)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(err, d)
        print(f"K4 vs plain {label}: max_abs_diff {d} on qcoeff, eobs, "
              f"skipped and states; plain {ms:.1f} ms, "
              f"{sum(ED.plain_reads)} bool reads", flush=True)
        if d or not same:
            fail(f"K4 disagrees with detokenize_frame_plain on {label}")
        return ms, list(ED.plain_reads)

    for f in (0, 1, 15):
        R, C, P, *arrays = dec.kept[f]
        plain_ms[f], reads[f] = k4_vs_plain(f"bench_1080p frame {f}", R, C,
                                            P, arrays)
    for name in ("part4_cif", "inter_qcif"):
        path = os.path.join(VECTORS, f"{name}.ivf")
        n = len(tool.read_ivf(path).frames)
        small = tool.measure(path, n, "cuda", keep=range(n))
        for f in range(n):
            R, C, P, *arrays = small.kept[f]
            k4_vs_plain(f"{name} frame {f} (P={P})", R, C, P, arrays)
    rng = np.random.default_rng(17)
    R, C, P, L = 17, 30, 8, 4096
    N = R * C
    k4_vs_plain("random bytes 17x30, P=8", R, C, P, [
        rng.integers(0, 256, (P, L)).astype(np.uint8),
        rng.integers(L // 2, L + 1, P).astype(np.int32),
        np.tile(np.asarray([0, 255, -8, 0], np.int32), (P, 1)),
        dec.kept[1][6], rng.random(N) < 0.7,
        (rng.random(N) < 0.2).astype(np.int32)])
    k4_vs_plain("R=2 < P=4", 2, 3, 4, [
        rng.integers(0, 256, (4, 64)).astype(np.uint8),
        np.asarray([64, 40, 64, 64], np.int32),
        np.asarray([[0, 255, -8, 0], [0x5A0000, 200, 2, 5],
                    [0x123456, 200, 3, 17], [7, 129, -3, 60]], np.int32),
        dec.kept[0][6], np.asarray([1, 0, 1, 1, 1, 0], bool),
        np.asarray([0, 0, 1, 0, 0, 1], np.int32)])

    # each 1080p frame's launch alone (outputs allocated and zeroed
    # before the first event), and the bytes bound from this run's sizes:
    # each input read once, each output written once
    alone, byte_s = [], []
    for f in range(n_frames):
        R, C, P, *arrays = dec.kept[f]
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in arrays]
        ED._check_cuda(R, C, P, t)
        N = R * C
        i32 = torch.int32
        out = (torch.zeros((N, 25, 16), dtype=i32, device=dev),
               torch.empty((N, 25), dtype=i32, device=dev),
               torch.empty(N, dtype=i32, device=dev),
               torch.empty((P, 4), dtype=i32, device=dev))
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        ED.launch(R, C, P, *t, *out)
        e1.record()
        if f == 0:                 # read while the keyframe's launch runs
            clocks = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip()
        e1.synchronize()
        alone.append(e0.elapsed_time(e1))
        byte_s.append((sum(a.nbytes for a in arrays) +
                       sum(o.numel() * 4 for o in out)) / HBM_BYTES_PER_S)
    key_ms, inter_ms = alone[0], statistics.mean(alone[1:])
    rows = dec.rows
    host_key = rows[0]["host_ms"]
    host_inter = statistics.mean(r["host_ms"] for r in rows[1:])
    wrap_key = rows[0]["wrapper_ms"]
    wrap_inter = statistics.mean(r["wrapper_ms"] for r in rows[1:])
    # ~12 integer operations per bool read (split, compare, select,
    # normalise, fill) over the 32-bit rate, on the frames whose reads the
    # plain version counted
    op_s = {f: 12 * sum(reads[f]) / INT_OPS_PER_S for f in reads}
    bound_ms = statistics.mean(byte_s) * 1e3
    bound_by = "bytes" if all(byte_s[f] >= op_s[f] for f in reads) \
        else "operations"
    ns_key = key_ms * 1e6 / max(reads[0])
    ns_inter = statistics.mean(alone[f] * 1e6 / max(reads[f])
                               for f in (1, 15))
    print(f"K4 detokenize on bench_1080p (P=1), launch alone by events: "
          f"keyframe {key_ms:.3f} ms ({max(reads[0])} dependent bool reads, "
          f"{ns_key:.2f} ns/read), inter frames mean {inter_ms:.3f} ms "
          f"(frames 1/15: {max(reads[1])}/{max(reads[15])} reads, "
          f"{ns_inter:.2f} ns/read); through the wrapper with uploads "
          f"{wrap_key:.3f} / {wrap_inter:.3f} ms; host C++ "
          f"{host_key:.3f} / {host_inter:.3f} ms; K4 / host on inter "
          f"frames {inter_ms / host_inter:.2f}x; plain (CPU) "
          f"{plain_ms[0]:.1f} / {plain_ms[1]:.1f} / {plain_ms[15]:.1f} ms "
          f"(frames 0/1/15); bound by bytes {bound_ms:.4f} ms/frame "
          f"(operations {op_s[0] * 1e3:.5f} ms on the keyframe); SM clock "
          f"during the keyframe's launch, and its maximum: {clocks} [{card}]",
          flush=True)

    # the port's headline bench as a user runs it
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "bench_torch.py")],
        env=dict(os.environ, BENCH_RUNS="3"), capture_output=True,
        text=True, timeout=600, cwd=HERE)
    for line in proc.stderr.strip().splitlines()[-6:]:
        print(f"  bench_torch: {line}", flush=True)
    try:
        line = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        line = None
    if proc.returncode != 0 or line is None or \
            line.get("metric") != "1080p_decode_fps_bit_exact_torch" or \
            not line.get("value"):
        fail(f"bench_torch.py: exit {proc.returncode}, last line "
             f"{proc.stdout.strip()[-300:]!r}, stderr "
             f"{proc.stderr.strip()[-2000:]!r}")
    print(f"bench_torch.py (BENCH_RUNS=3): {line['value']} fps bit-exact, "
          f"{line['vs_baseline']}x the 19.6 fps vpxdec baseline [{card}]",
          flush=True)
    print(f"entropy phases: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return {"detokenize": count}, {
        "name": "detokenize", "route": "cuda",
        "source": "libvpx_opencl_tpu_torch/csrc/detokenize.cu",
        "replaces": "libvpx_opencl_tpu/ops/entropy_device.py:239",
        "launches": count, "max_abs_err": err, "max_abs_diff": err,
        "ms": statistics.mean(alone),
        "plain_ms": statistics.mean(plain_ms.values()),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "card": card, "key_ms": key_ms, "inter_ms": inter_ms,
        "wrapper_key_ms": wrap_key, "wrapper_inter_ms": wrap_inter,
        "host_key_ms": host_key, "host_inter_ms": host_inter,
        "plain_key_ms": plain_ms[0],
        "plain_inter_ms": statistics.mean([plain_ms[1], plain_ms[15]]),
        "chain_reads_key": max(reads[0]),
        "chain_reads_inter": [max(reads[1]), max(reads[15])],
        "ns_per_read_key": ns_key, "ns_per_read_inter": ns_inter,
        "sm_clocks_during_key": clocks,
        "upload_bytes": summary["upload_bytes"],
        "coef_upload_bytes": summary["coef_upload_bytes"],
        "bench_torch_fps": line["value"]}


def inter_recon_phases(torch, np, card, err):
    """Stages 1-2 of the decoder (csrc/inter_recon.cu) on the card:
    bench_1080p decoded through TorchDecoder with each frame's stage 1-2
    inputs kept (MD5 of every frame, one launch per frame, CUDA events
    around the wrapper inside the decoder, queued behind a sleep kernel);
    then, on every frame's inputs,
    the kernel against the plain `inter_planes` on the card (residuals and
    inter MBs' pixels exact), the launch alone by CUDA events (median of
    3, queued behind a sleep kernel, and from an idle card), the host's
    time to enqueue the wrapper and the plain version, the
    plain version's time on the card, and the bound by bytes. Returns
    (its main-path launches, its `kernels` entry)."""
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.ops import wavefront as W
    from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s

    t_start = time.perf_counter()
    bench = os.path.join(VECTORS, "bench_1080p.ivf")
    golden = load_golden_md5s(bench + ".md5")
    kernel = TD.inter_recon_planes
    kept, events = [], []

    def clone(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: v.clone() for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(clone(t) for t in x)
        return x.clone()

    def probe(R, C, refs, mb, taps, split):
        kept.append((R, C, clone(refs), clone(mb), taps, clone(split)))
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        # queued behind a ~10 ms sleep kernel: e1 is recorded only after
        # the ctypes call has taken the interpreter lock back, which the
        # entropy thread may hold for the 5 ms switch interval
        torch.cuda._sleep(20_000_000)
        e0.record()
        out = kernel(R, C, refs, mb, taps, split)
        e1.record()
        events.append((e0, e1))
        return out

    W.launches["inter_recon"] = 0
    TD.inter_recon_planes = probe
    try:
        md5s = [frame_md5(*p) for p in TD.decode_ivf_torch(bench,
                                                            device="cuda")]
    finally:
        TD.inter_recon_planes = kernel
    count = W.launches["inter_recon"]
    if md5s != golden:
        fail("bench_1080p with the inter_recon probe: MD5 mismatch")
    if count != len(kept) or count != len(golden):
        fail(f"inter_recon: {count} launches for {len(kept)} frames; one "
             "per frame is the design")
    in_decoder = [a.elapsed_time(b) for a, b in events]

    def same(R, C, mb, got, want):
        (gp, gr), (wp, wr) = got, want
        d = max(int((g - w).abs().max()) for g, w in zip(gr, wr))
        idx = mb["inter_idx"]
        r, c = idx // C, idx % C
        for g, w, n in zip(gp, wp, (16, 8, 8)):
            d = max(d, int((W.mb_view(g, R, C, n)[r, c].int() -
                            W.mb_view(w, R, C, n)[r, c].int()).abs()
                           .max()) if len(idx) else 0)
        return d

    alone, idle, host_k, host_p, plain, bounds, inter_mbs = (
        [], [], [], [], [], [], [])
    worst = 0
    with torch.inference_mode():
        # the plain version's torch ops warmed up on an inter frame's inputs
        R, C, refs, mb, taps, split = kept[1]
        TD.inter_planes(R, C, tuple(torch.stack(p) for p in refs), mb, taps,
                        split)
        for R, C, refs, mb, taps, split in kept:
            stacked = None if refs is None else tuple(torch.stack(p)
                                                      for p in refs)
            # the launch queued behind a ~0.5 ms sleep kernel, so that its
            # events hold the kernel and not the host's ~0.15 ms launch
            # path; from an idle card for comparison
            ts, ts_idle = [], []
            for _ in range(3):
                for queued in (True, False):
                    torch.cuda.synchronize()
                    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
                    if queued:
                        torch.cuda._sleep(1_000_000)
                    t0 = time.perf_counter()
                    e0.record()
                    got = kernel(R, C, refs, mb, taps, split)
                    e1.record()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    (ts if queued else ts_idle).append(
                        (e0.elapsed_time(e1), (t1 - t0) * 1e3))
            alone.append(statistics.median(t[0] for t in ts))
            idle.append(statistics.median(t[0] for t in ts_idle))
            host_k.append(statistics.median(t[1] for t in ts_idle))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = TD.inter_planes(R, C, stacked, mb, taps, split)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host_p.append((t1 - t0) * 1e3)
            plain.append((time.perf_counter() - t0) * 1e3)
            worst = max(worst, same(R, C, mb, got, want))
            # bytes, each read once and each written once: the table's
            # columns read (8 per MB, 5 more per inter MB), coefficients,
            # the inter list, the SPLITMV lists, the reference windows
            # (21x21 + 2x13x13 per MB, 24 9x9 tiles per SPLITMV MB), the
            # int32 residuals and the inter MBs' pixels
            N, K = R * C, mb["inter_idx"].shape[0]
            S = 0 if split is None else split[0].shape[0]
            byts = (N * (8 * 4 + 800 + 384 * 4) +
                    K * (5 * 4 + 8 + 441 + 2 * 169 + 384) +
                    S * (8 + 128 + 32 + 24 * 81 - 441 - 2 * 169))
            bounds.append(byts / HBM_BYTES_PER_S * 1e3)
            inter_mbs.append(K)
    err["inter_recon"] = max(err.get("inter_recon", 0), worst)
    if worst:
        fail(f"inter_recon disagrees with inter_planes on a 1080p frame "
             f"(max_abs_diff {worst})")
    key = [i for i, k in enumerate(inter_mbs) if k == 0]
    inter = [i for i, k in enumerate(inter_mbs) if k]

    def mean(xs, sel):
        return statistics.mean(xs[i] for i in sel) if sel else None

    print(f"inter_recon on bench_1080p: {count} launches for {len(golden)} "
          f"frames, MD5-exact; == inter_planes on every frame (max_abs_diff "
          f"{worst}) [{card}]", flush=True)
    for label, sel in (("keyframe", key), ("mean inter frame", inter)):
        print(f"inter_recon {label} ({len(sel)} frames, inter MBs "
              f"{mean(inter_mbs, sel):.0f}): alone {mean(alone, sel):.4f} "
              f"ms queued, {mean(idle, sel):.4f} ms from an idle card, in "
              f"the decoder {mean(in_decoder, sel):.4f} ms, bound "
              f"{mean(bounds, sel):.4f} ms by bytes; host enqueue "
              f"{mean(host_k, sel):.4f} ms; plain inter_planes on the card "
              f"{mean(plain, sel):.4f} ms, of it host enqueue "
              f"{mean(host_p, sel):.4f} ms [{card}]", flush=True)
    print(f"inter_recon phases: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return {"inter_recon": count}, {
        "name": "inter_recon", "route": "cuda",
        "source": "libvpx_opencl_tpu_torch/csrc/inter_recon.cu",
        "replaces": "none (libvpx_opencl_tpu/models/tpu_decoder.py XLA "
                    "stages _residuals_*, _mc_dense_device, "
                    "_mc_fixup_device)",
        "launches": count, "max_abs_err": worst, "max_abs_diff": worst,
        "ms": statistics.mean(alone), "plain_ms": statistics.mean(plain),
        "bound_ms": statistics.mean(bounds), "bound_by": "bytes",
        "library_ms": None, "card": card,
        "key_ms": mean(alone, key), "inter_ms": mean(alone, inter),
        "idle_card_key_ms": mean(idle, key),
        "idle_card_inter_ms": mean(idle, inter),
        "in_decoder_key_ms": mean(in_decoder, key),
        "in_decoder_inter_ms": mean(in_decoder, inter),
        "plain_key_ms": mean(plain, key), "plain_inter_ms": mean(plain, inter),
        "host_enqueue_ms": statistics.mean(host_k),
        "plain_host_enqueue_ms": statistics.mean(host_p),
        "bound_key_ms": mean(bounds, key),
        "bound_inter_ms": mean(bounds, inter)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    from libvpx_opencl_tpu_torch import api
    from libvpx_opencl_tpu_torch.models import torch_decoder as TD
    from libvpx_opencl_tpu_torch.models import torch_encoder as TE
    from libvpx_opencl_tpu_torch.models import wavefront as EW
    from libvpx_opencl_tpu_torch.models.refdec import INTRA_FRAME
    from libvpx_opencl_tpu_torch.ops import _cuda
    from libvpx_opencl_tpu_torch.ops import me as ME
    from libvpx_opencl_tpu_torch.ops import me_sad
    from libvpx_opencl_tpu_torch.ops import rd_device as RD
    from libvpx_opencl_tpu_torch.ops import wavefront as W
    from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
    from libvpx_opencl_tpu_torch.utils.md5 import frame_md5, load_golden_md5s

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _cuda.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc, "
          f"{len(_cuda.KERNELS)} sources in parallel)", flush=True)
    for name, rep in _cuda.ptxas_report.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    def to_dev(arrs):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                .to(torch.bool if a.dtype == bool else torch.int32)
                for a in arrs]

    # -- K1 / K2 vs plain on random cases --------------------------------
    err = {"intra_wavefront": 0, "lf_wavefront": 0, "sad_grid": 0,
           "encode_wavefront": 0, "trellis": 0}
    for R, C in GEOMS:
        rng = np.random.default_rng(R * 1000 + C)
        args = to_dev(intra_case(np, rng, R, C))
        got = W.intra_recon(R, C, *args)
        want = W.intra_recon_plain(R, C, *args)
        d = max_abs_diff(torch, got, want)
        print(f"K1 vs plain {R}x{C}: max_abs_diff {d}", flush=True)
        if d:
            fail(f"K1 disagrees with intra_recon_plain at {R}x{C}")
        err["intra_wavefront"] = max(err["intra_wavefront"], d)
        largs = to_dev(lf_case(np, rng, R, C))
        for simple in (False, True):
            got = W.loop_filter(R, C, simple, *largs)
            want = W.loop_filter_plain(R, C, simple, *largs)
            d = max_abs_diff(torch, got, want)
            print(f"K2 vs plain {R}x{C} simple={simple}: max_abs_diff {d}",
                  flush=True)
            if d:
                fail(f"K2 disagrees with loop_filter_plain at {R}x{C}")
            err["lf_wavefront"] = max(err["lf_wavefront"], d)
    torch.cuda.synchronize()
    k5_phases(torch, np, err)
    k6_phases(torch, np, err)

    # -- main path: bench_1080p through the port's entry point -----------
    bench = os.path.join(VECTORS, "bench_1080p.ivf")
    golden = load_golden_md5s(bench + ".md5")
    for name in W.launches:
        W.launches[name] = 0
    per_frame = []                # (K1, K2, inter_recon launches, level)
    src_frames = []               # decoded frames 0-9: the encoder's input
    n = 0
    dec = TD.TorchDecoder(device="cuda")
    for payload, _pts in read_ivf(bench).frames:
        before = dict(W.launches)
        show, planes = dec.decode_frame(payload)
        per_frame.append((
            W.launches["intra_wavefront"] - before["intra_wavefront"],
            W.launches["lf_wavefront"] - before["lf_wavefront"],
            W.launches["inter_recon"] - before["inter_recon"],
            dec.filter_level))
        if not show:
            continue
        if n < DEFAULT_FRAMES:
            src_frames.append(tuple(np.array(p) for p in planes))
        if n >= len(golden) or frame_md5(*planes) != golden[n]:
            fail(f"bench_1080p frame {n}: MD5 mismatch")
        n += 1
    launches = dict(W.launches)
    if n != len(golden):
        fail(f"bench_1080p: {n} frames decoded, {len(golden)} expected")
    print(f"bench_1080p: {n}/{len(golden)} frames MD5-exact", flush=True)
    print(f"launches per frame (K1, K2, inter_recon, filter level): "
          f"{per_frame}", flush=True)
    for i, (k1, k2, k7, level) in enumerate(per_frame):
        if k1 != 1 or k2 != (1 if level else 0) or k7 != 1:
            fail(f"bench_1080p frame {i} (filter level {level}) launched K1 "
                 f"{k1}, K2 {k2} and inter_recon {k7} times; one launch "
                 "each is the design")

    for name in EXTRA_STREAMS:
        path = os.path.join(VECTORS, f"{name}.ivf")
        gold = load_golden_md5s(path + ".md5")
        got = [frame_md5(*p) for p in TD.decode_ivf_torch(path,
                                                          device="cuda")]
        if got != gold:
            fail(f"{name}: MD5 mismatch")
        print(f"{name}: {len(got)}/{len(gold)} frames MD5-exact", flush=True)

    # -- stages 1-2: inter_recon against inter_planes, its times ---------
    k7_launches, k7_entry = inter_recon_phases(torch, np, card, err)
    for name, count in k7_launches.items():
        launches[name] += count

    # -- decode throughput (bench.py's semantics: decode only) -----------
    frames = read_ivf(bench).frames

    def decode_all():
        dec = TD.TorchDecoder(device="cuda")
        for payload, _pts in frames:
            dec.decode_frame_core(payload)
        dec._sync()
        torch.cuda.synchronize()

    decode_all()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        decode_all()
        runs.append(time.perf_counter() - t0)
    fps = len(frames) / statistics.median(runs)
    print(f"decode bench_1080p: {fps:.2f} fps (median of 3: "
          f"{[round(r, 4) for r in runs]} s) [{card}]", flush=True)

    # -- per-kernel time on the main path's inputs -----------------------
    # Wrap the plane-level entries the decoder calls: time every launch
    # with CUDA events inside the decoder, keep every frame's inputs (and a
    # few frames' outputs), then time each frame's launch alone and run the
    # plain versions on the same inputs.
    k1_fn, k2_fn = W.intra_recon_planes, W.loop_filter_planes
    sample = {0, 1, len(frames) // 2}
    rec = {"k1": [], "k2": []}
    every = {"k1": [], "k2": []}
    kept = {"k1": [], "k2": []}
    stats = {"k1": [], "k2": []}

    def probe_k1(R, C, y, u, v, ry, ru, rv, params):
        f = len(rec["k1"])
        inp = (R, C, [t.clone() for t in (y, u, v)],
               [t.clone() for t in (ry, ru, rv)], params.clone())
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        k1_fn(R, C, y, u, v, ry, ru, rv, params)
        e1.record()
        rec["k1"].append((e0, e1))
        every["k1"].append(inp)
        stats["k1"].append((params[:, 2].clone(), params[:, 0].clone()))
        if f in sample:
            kept["k1"].append((*inp, [t.clone() for t in (y, u, v)]))

    def probe_k2(R, C, simple, y, u, v, params):
        f = len(rec["k2"])
        inp = (R, C, simple, [t.clone() for t in (y, u, v)], params.clone())
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        k2_fn(R, C, simple, y, u, v, params)
        e1.record()
        rec["k2"].append((e0, e1))
        every["k2"].append(inp)
        stats["k2"].append(params[:, 0].clone())
        if f in sample:
            kept["k2"].append((*inp, [t.clone() for t in (y, u, v)]))

    W.intra_recon_planes, W.loop_filter_planes = probe_k1, probe_k2
    try:
        decode_all()
    finally:
        W.intra_recon_planes, W.loop_filter_planes = k1_fn, k2_fn
    in_decoder_ms = {k: statistics.mean(a.elapsed_time(b) for a, b in v)
                     for k, v in rec.items()}

    def time_alone(call, cases, rows=None):
        """Mean over frames of the median of 3 event-timed wrapper calls,
        each on fresh copies of the frame's planes; `rows`: only the first
        MB rows of each frame."""
        per = []
        for case in cases:
            ts = []
            R, C = rows or case[0], case[1]
            for _ in range(3):
                planes = [t[:shape[0]].clone() for t, shape in zip(
                    case[-3 if call is k1_fn else -2], W.plane_shapes(R, C))]
                torch.cuda.synchronize()
                e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
                e0.record()
                if call is k1_fn:
                    call(R, C, *planes, *(t[:R * C] for t in case[3]),
                         case[4][:R * C])
                else:
                    call(R, C, case[2], *planes, case[4][:R * C])
                e1.record()
                torch.cuda.synchronize()
                ts.append(e0.elapsed_time(e1))
            per.append(statistics.median(ts))
        return statistics.mean(per)

    with torch.inference_mode():
        k_ms = {"k1": time_alone(k1_fn, every["k1"]),
                "k2": time_alone(k2_fn, every["k2"])}
        # the keyframe (every MB intra and filtered), whole and its first
        # MB row alone: full = (C + 2(R-1)) * step + (R-1) * hand-off
        key_ms = {k: (time_alone(fn, every[k][:1]),
                      time_alone(fn, every[k][:1], rows=1))
                  for k, fn in (("k1", k1_fn), ("k2", k2_fn))}
    del every

    def time_plain(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_ms = {"k1": [], "k2": []}

    def check_plain():
        for R, C, inp, res, params, out in kept["k1"]:
            planes = [t.clone() for t in inp]
            plain_ms["k1"].append(time_plain(lambda: W._intra_planes_plain(
                R, C, *planes, *res, params)))
            d = max_abs_diff(torch, planes, out)
            err["intra_wavefront"] = max(err["intra_wavefront"], d)
            if d:
                fail("K1 disagrees with its plain version on a 1080p frame")
        for R, C, simple, inp, params, out in kept["k2"]:
            planes = [t.clone() for t in inp]
            plain_ms["k2"].append(time_plain(lambda: W._lf_planes_plain(
                R, C, simple, *planes, params)))
            d = max_abs_diff(torch, planes, out)
            err["lf_wavefront"] = max(err["lf_wavefront"], d)
            if d:
                fail("K2 disagrees with its plain version on a 1080p frame")

    # the decoder's worker runs under inference mode; so do its plain twins
    with torch.inference_mode():
        check_plain()

    # least time for the same work, per frame, from this run's data: bytes
    # each input read once / output written once, and the integer
    # operations the per-pixel arithmetic needs, whichever is longer
    R, C = kept["k1"][0][0], kept["k1"][0][1]
    N = R * C
    k1_bounds, k2_bounds = [], []
    for intra, mode in stats["k1"]:
        ni = int(intra.sum())
        nb = int(((mode == W.B_PRED_M) & (intra != 0)).sum())
        byts = N * 4 + ni * (384 * 4 + W.INTRA_COLS * 4 + 384)
        ops = ni * 384 * 8 + nb * 256 * 24
        k1_bounds.append((byts / HBM_BYTES_PER_S, ops / INT_OPS_PER_S))
    for flevel in stats["k2"]:
        na = int((flevel > 0).sum())
        byts = N * 4 + na * (W.LF_COLS * 4 + 2 * 384)
        ops = na * (8 * 16 + 8 * 8) * 60
        k2_bounds.append((byts / HBM_BYTES_PER_S, ops / INT_OPS_PER_S))

    def bound(bs):
        b = statistics.mean(x[0] for x in bs)
        o = statistics.mean(x[1] for x in bs)
        return max(b, o) * 1e3, ("bytes" if b >= o else "operations")

    steps = W.diag_depth(R, C)
    for key, name in (("k1", "K1 intra_wavefront"), ("k2", "K2 lf_wavefront")):
        per = len(rec[key]) / len(frames)
        print(f"{name}: {k_ms[key]:.4f} ms/frame alone on each decoded "
              f"frame's inputs ({in_decoder_ms[key]:.4f} ms/frame by events "
              f"around the wrapper inside the decoder), {per:g} "
              f"launches/frame, chain of {steps} dependent MB steps, "
              f"{k_ms[key] * 1e3 / steps:.3f} us/step [{card}]", flush=True)
        full, row = key_ms[key]
        step_us = row * 1e3 / C
        hand_us = (full * 1e3 - steps * step_us) / (R - 1)
        print(f"{name} on the keyframe: {full:.4f} ms, its first MB row "
              f"alone {row:.4f} ms: {step_us:.3f} us per MB step, "
              f"{hand_us:.3f} us per hand-off between rows [{card}]",
              flush=True)

    # -- the user surface: decoder API, reference controls, EC, postproc,
    # the CLI, ARNR and the analysis ops -----------------------------------
    for name, count in surface_phases(torch, np, card).items():
        launches[name] += count

    # -- K3 vs plain ------------------------------------------------------
    def search_case(rng, R, C, plane=None, src=None):
        """Bordered plane, source blocks, pre-clamped non-zero centres and
        MB positions of an R x C grid (as TorchEncoder makes them)."""
        N = R * C
        if plane is None:
            plane = rng.integers(0, 256, (R * 16 + 64, C * 16 + 64)) \
                .astype(np.uint8)
            src = rng.integers(0, 256, (N, 16, 16)).astype(np.int32)
        mbr, mbc = np.arange(N) // C, np.arange(N) % C
        lo = np.stack([-(mbr * 16) - 16, -(mbc * 16) - 16], 1)
        hi = np.stack([(R - 1 - mbr) * 16 + 16, (C - 1 - mbc) * 16 + 16], 1)
        cen = np.clip(rng.integers(-40, 41, (N, 2)), lo, hi).astype(np.int32)
        pos = np.stack([32 + 16 * mbr, 32 + 16 * mbc], 1).astype(np.int32)
        return plane, src, cen, pos

    def bordered(vis, R, C):
        """Visible luma plane -> MB-aligned plane with an edge-extended
        border of 32."""
        return np.pad(vis, ((32, 32 + R * 16 - vis.shape[0]),
                            (32, 32 + C * 16 - vis.shape[1])), mode="edge")

    def k3_windows(label, plane, wy, wx, src, rng=ME.RNG):
        """K3 vs sad_grid_plain on explicit windows; returns K3's grid."""
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (plane, wy, wx, src)]
        got = me_sad.sad_grid(*args, rng)
        torch.cuda.synchronize()
        d = int((got - me_sad.sad_grid_plain(*args, rng)).abs().max())
        print(f"K3 vs plain {label}: max_abs_diff {d}", flush=True)
        err["sad_grid"] = max(err["sad_grid"], d)
        if d:
            fail(f"K3 disagrees with sad_grid_plain at {label}")
        return got

    def k3_vs_plain(label, plane, src, cen, pos, rng=ME.RNG):
        return k3_windows(label, plane, pos[:, 0] + cen[:, 0] - rng,
                          pos[:, 1] + cen[:, 1] - rng, src, rng)

    for R, C in [(6, 8), (3, 3), (1, 5), (5, 1)]:
        k3_vs_plain(f"{R}x{C} (N={R * C})",
                    *search_case(np.random.default_rng(R * 1000 + C), R, C))
    for rng in (7, 1):
        k3_vs_plain(f"6x8 rng {rng}", *search_case(
            np.random.default_rng(6008 + rng), 6, 8), rng=rng)
    # windows starting at every column mod 4, N = 40
    gen = np.random.default_rng(404)
    k3_windows("wx mod 4 = 0, 1, 2, 3 (N=40)",
               gen.integers(0, 256, (120, 130)).astype(np.uint8),
               gen.integers(0, 73, 40).astype(np.int32),
               (4 * gen.integers(0, 20, 40) + np.arange(40) % 4)
               .astype(np.int32),
               gen.integers(0, 256, (40, 16, 16)).astype(np.int32))
    # saturation: plane 0, source 255, every SAD 255 * 256
    sat = k3_windows("plane 0, source 255 (N=24)",
                     np.zeros((100, 110), np.uint8),
                     np.arange(24, dtype=np.int32) * 2,
                     np.arange(24, dtype=np.int32) * 2 + 1,
                     np.full((24, 16, 16), 255, np.int32))
    if not bool((sat == 65280).all()):
        fail("K3 does not reach SAD 65280 on plane 0 / source 255")
    R, C = 68, 120
    ref_pl = bordered(src_frames[0][0], R, C)
    blocks = bordered(src_frames[1][0], R, C)[32:-32, 32:-32] \
        .reshape(R, 16, C, 16).transpose(0, 2, 1, 3).reshape(R * C, 16, 16) \
        .astype(np.int32)
    k3_vs_plain("68x120 (N=8160) on a decoded 1080p frame", *search_case(
        np.random.default_rng(68120), R, C, ref_pl, blocks))
    # ties: a constant plane gives equal SADs at every offset; the card
    # must pick the same (first) one as the CPU
    flat = (np.full((4 * 16 + 64, 6 * 16 + 64), 90, np.uint8),
            np.full((24, 16, 16), 90, np.int32))
    _, _, cen, pos = search_case(np.random.default_rng(46), 4, 6, *flat)
    on_cpu = [torch.from_numpy(a) for a in (*flat, cen, pos)]
    mv_c, sad_c = ME.full_search(*on_cpu, step=1)
    mv_g, sad_g = ME.full_search(*(t.to(dev) for t in on_cpu), step=1)
    if not (torch.equal(mv_g.cpu(), mv_c) and torch.equal(sad_g.cpu(), sad_c)):
        fail("full_search resolves ties differently on the card")
    print("K3 ties on a constant plane: card == CPU", flush=True)

    # -- small reference: the card's payloads equal the CPU's --------------
    def synth_clip(w, h, n):
        """A moving gradient with a moving bright box, n frames."""
        yy, xx = np.mgrid[0:h, 0:w]
        clip = []
        for t in range(n):
            y = ((xx + yy + 7 * t) % 220 + 10).astype(np.uint8)
            y[20:60, 30 + 3 * t:70 + 3 * t] = 200
            clip.append((y, ((xx[::2, ::2] // 2 + t) % 255).astype(np.uint8),
                         ((yy[::2, ::2] // 2 + 255 - t) % 255)
                         .astype(np.uint8)))
        return clip

    small = {}
    for where in ("cpu", "cuda"):
        enc = TE.TorchEncoder(176, 144, qindex=24, device=where)
        enc.sf = TE.SLICE2_SF
        small[where] = [enc.encode_frame(*f) for f in synth_clip(176, 144, 3)]
    if small["cpu"] != small["cuda"]:
        fail("QCIF payloads encoded on the card differ from the CPU's")
    print(f"encode QCIF 3 frames under SLICE2_SF: card payloads == CPU "
          f"payloads ({[len(p) for p in small['cuda']]} bytes)", flush=True)

    # -- main path 2: encode 1 key + 3 inter 1080p frames ------------------
    def new_encoder():
        enc = TE.TorchEncoder(1920, 1080, qindex=24, device="cuda")
        enc.sf = TE.SLICE2_SF
        return enc

    def refs_searched(enc):
        return 1 + (enc.ref_gold is not enc.ref_last) + (
            enc.ref_alt is not enc.ref_last
            and enc.ref_alt is not enc.ref_gold)

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return 10 * np.log10(255 ** 2 / mse) if mse > 0 else 99.0

    slice2_frames = src_frames[:SLICE2_FRAMES]
    for name in W.launches:
        W.launches[name] = 0
    enc = new_encoder()
    dec = TD.TorchDecoder(device="cuda")
    enc_launches = {"sad_grid": 0, "lf_wavefront": 0, "encode_wavefront": 0}
    slice2_bytes, slice2_payloads = [], []
    for i, frame in enumerate(slice2_frames):
        want_k3 = refs_searched(enc) if i else 0
        before = dict(W.launches)
        payload = enc.encode_frame(*frame)
        slice2_bytes.append(len(payload))
        slice2_payloads.append(payload)
        k3 = W.launches["sad_grid"] - before["sad_grid"]
        k2 = W.launches["lf_wavefront"] - before["lf_wavefront"]
        k5 = W.launches["encode_wavefront"] - before["encode_wavefront"]
        k6 = W.launches["trellis"] - before["trellis"]
        enc_launches["sad_grid"] += k3
        enc_launches["lf_wavefront"] += k2
        enc_launches["encode_wavefront"] += k5
        # the decoder that checks the payload launches K1 and K2 too:
        # those launches are a check and are not counted
        show, planes = dec.decode_frame(payload)
        recon = enc.ref_last.visible()
        p = psnr(frame[0], recon[0])
        print(f"encode 1080p frame {i} ({'key' if i == 0 else 'inter'}): "
              f"{len(payload)} bytes, luma PSNR {p:.2f} dB, K3 launches "
              f"{k3}, K2 launches {k2}, K5 launches {k5}, K6 launches {k6}",
              flush=True)
        if k3 != want_k3 or k2 != 1 or k5 != 1 or k6 != 0:
            fail(f"encode frame {i}: K3 launched {k3} times for {want_k3} "
                 f"references, K2 {k2} times for one loop filter, K5 {k5} "
                 f"times for one encode wavefront, K6 {k6} times with the "
                 f"trellis off")
        if not show or any(not np.array_equal(a, b)
                           for a, b in zip(planes, recon)):
            fail(f"encode frame {i}: the decoded payload differs from the "
                 f"encoder's reconstruction")
        if p < 30.0:
            fail(f"encode frame {i}: luma PSNR {p:.2f} dB < 30 dB")
    for name, count in enc_launches.items():
        launches[name] += count

    # -- encode times (the run above was the warm-up) ----------------------
    # The encode wavefront is timed inside the same run (two more
    # synchronisations per frame), and full_search's tensors are kept for
    # the route comparison below.
    enc = new_encoder()
    ew_fn, fs_fn = EW.encode_recon_planes, ME.full_search
    frame_s, ew_s, ew_steps, fs_args = [], [], [], []

    def probe_ew(*a):
        # a = (R, C, three source and three prediction tensors, mode,
        # uv_mode, intra, ...)
        ew_steps.append(k5_chain(np, a[0], a[1], a[10].cpu().numpy(),
                                 (a[8] == W.B_PRED_M).cpu().numpy()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ew_fn(*a)
        torch.cuda.synchronize()
        ew_s.append(time.perf_counter() - t0)
        return out

    def probe_fs(*a, **kw):
        fs_args.append((a, kw))
        return fs_fn(*a, **kw)

    EW.encode_recon_planes, ME.full_search = probe_ew, probe_fs
    try:
        for frame in slice2_frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc.encode_frame(*frame)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
    finally:
        EW.encode_recon_planes, ME.full_search = ew_fn, fs_fn
    enc_fps = (len(frame_s) - 1) / sum(frame_s[1:])
    print(f"encode 1080p: {enc_fps:.4f} frames/s over {len(frame_s) - 1} "
          f"inter frames ({[round(x, 3) for x in frame_s[1:]]} s), keyframe "
          f"{frame_s[0]:.3f} s [{card}]", flush=True)
    print(f"encode wavefront (encode_recon_planes: inter batch + K5) of "
          f"those frames: keyframe {ew_s[0]:.4f} s, inter "
          f"{[round(x, 4) for x in ew_s[1:]]} s; K5's chain of dependent MB "
          f"steps {ew_steps} [{card}]", flush=True)

    # K3 route vs plain route on inter frame 1's tensors
    fa, fkw = fs_args[0]
    mv_k, sad_k = ME.full_search(*fa, **fkw)
    sad_fn = me_sad.sad_grid
    me_sad.sad_grid = me_sad.sad_grid_plain
    try:
        mv_p, sad_p = ME.full_search(*fa, **fkw)
    finally:
        me_sad.sad_grid = sad_fn
    if not (torch.equal(mv_k, mv_p) and torch.equal(sad_k, sad_p)):
        fail("full_search through K3 differs from full_search through "
             "sad_grid_plain on inter frame 1")
    print("full_search on inter frame 1: K3 route == plain route "
          f"({int((mv_k != 0).any(1).sum())} of {mv_k.shape[0]} MVs "
          "non-zero)", flush=True)
    ref_plane, yb, centers, mb_pos = fa
    k3_args = (ref_plane, mb_pos[:, 0] + centers[:, 0] - ME.RNG,
               mb_pos[:, 1] + centers[:, 1] - ME.RNG, yb)
    got = me_sad.sad_grid(*k3_args)
    want = me_sad.sad_grid_plain(*k3_args)
    err["sad_grid"] = max(err["sad_grid"], int((got - want).abs().max()))
    if err["sad_grid"]:
        fail("K3 disagrees with sad_grid_plain on inter frame 1")
    # the launch alone (the wrapper's argument checks read two flags back
    # to the host, which leaves the card idle between launches), and
    # through the wrapper
    raw = (ref_plane, k3_args[1].to(torch.int32).contiguous(),
           k3_args[2].to(torch.int32).contiguous(), yb.contiguous(),
           torch.empty_like(got), ME.RNG, me_sad._plan(ME.RNG))
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    for key, call in (("k3", lambda: me_sad._launch(*raw)),
                      ("k3_wrapper", lambda: me_sad.sad_grid(*k3_args))):
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        e0.record()
        for _ in range(50):
            call()
        e1.record()
        torch.cuda.synchronize()
        k_ms[key] = e0.elapsed_time(e1) / 50
    if not torch.equal(raw[4], got):
        fail("K3's timed launches disagree with its first result")
    plain_ms["k3"] = [time_plain(lambda: me_sad.sad_grid_plain(*k3_args))
                      for _ in range(2)][1:]
    n_mb, n_off = yb.shape[0], (2 * ME.RNG + 1) ** 2
    k3_bounds = [((ref_plane.numel() + n_mb * (256 * 4 + 8)
                   + n_mb * n_off * 4) / HBM_BYTES_PER_S,
                  n_mb * n_off * 256 * 3 / INT_OPS_PER_S)]
    # yardstick (never called by the port): torch.cdist(p=1) on float32,
    # exact below 2^24; the candidates are unfolded outside the timed
    # window, 1020 MBs (1.1 GB) at a time, and the chunk times summed
    a48 = torch.arange(2 * ME.RNG + 16, device=dev)
    lib_ms = {"k3": 0.0}
    for c0 in range(0, n_mb, 1020):
        sl = slice(c0, c0 + 1020)
        win = ref_plane[(k3_args[1][sl, None] + a48)[:, :, None].long(),
                        (k3_args[2][sl, None] + a48)[:, None, :].long()]
        cand = win.float().unfold(1, 16, 1).unfold(2, 16, 1) \
            .reshape(-1, n_off, 256)
        x = yb[sl].reshape(-1, 1, 256).float()
        if c0 == 0:
            torch.cdist(x, cand, p=1)
        torch.cuda.synchronize()
        e0.record()
        d = torch.cdist(x, cand, p=1)
        e1.record()
        torch.cuda.synchronize()
        lib_ms["k3"] += e0.elapsed_time(e1)
        if not torch.equal(d.reshape(got[sl].shape).to(torch.int32),
                           got[sl]):
            fail("torch.cdist(p=1) disagrees with K3 on inter frame 1")
        del win, cand, d
    print(f"K3 sad_grid: {k_ms['k3']:.4f} ms/launch alone "
          f"({k_ms['k3_wrapper']:.4f} through the wrapper) (N={n_mb}), plain "
          f"{plain_ms['k3'][0]:.1f} ms, torch.cdist(p=1) "
          f"{lib_ms['k3']:.4f} ms (== K3), bound "
          f"{max(k3_bounds[0]) * 1e3:.4f} ms [{card}]", flush=True)

    # -- default speed features (B_PRED + trellis): card == CPU on QCIF ---
    small = {}
    for where in ("cpu", "cuda"):
        enc = TE.TorchEncoder(176, 144, qindex=24, device=where)
        payloads, bpred = [], []
        for f in synth_clip(176, 144, 3):
            payloads.append(enc.encode_frame(*f))
            bpred.append(int((enc.mode[1:, 1:] == W.B_PRED_M).sum()))
        codec = api.CodecEncoder(api.EncoderConfig(176, 144), device=where)
        for f in synth_clip(176, 144, 3):
            codec.encode(f)
        small[where] = (payloads, list(codec.get_cx_data()), bpred)
    if small["cpu"][0] != small["cuda"][0]:
        fail("default-feature QCIF payloads encoded on the card differ from "
             "the CPU's")
    if small["cpu"][1] != small["cuda"][1]:
        fail("CodecEncoder's QCIF packets on the card differ from the CPU's")
    print(f"encode QCIF 3 frames at default features (B_PRED, trellis): card "
          f"payloads == CPU payloads ({[len(p) for p in small['cuda'][0]]} "
          f"bytes, B_PRED MBs {small['cuda'][2]}); CodecEncoder card "
          f"packets == CPU packets", flush=True)

    # -- main path 3: 1 key + 9 inter 1080p frames at default features ---
    def default_encoder():
        return TE.TorchEncoder(1920, 1080, qindex=24, device="cuda")

    def frame_shape(enc):
        """(intra MBs, B_PRED MBs, the dependency levels the plain version
        walks)"""
        intra = (enc.reff[1:, 1:] == INTRA_FRAME).reshape(-1)
        bpred = (enc.mode[1:, 1:] == W.B_PRED_M).reshape(-1)
        lv = EW.intra_levels(enc.R, enc.C, intra, bpred)
        return int(intra.sum()), int(bpred.sum()), int(lv.max()) + 1

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(clone(v) for v in x)
        return x

    # every frame's encode_recon_planes and _trellis_mbs arguments are
    # kept for the K5 and K6 checks below, and K5's and K6's launches are
    # timed by CUDA events in the encoder
    ew_fn, k5_fn = EW.encode_recon_planes, EW._k5_launch
    tr_fn, k6_fn = TE._trellis_mbs, RD.k6_launch
    k5_inputs, k5_events, k6_inputs, k6_events = [], [], [], []

    def keep_ew(*a):
        k5_inputs.append(clone(a))
        return ew_fn(*a)

    def keep_tr(*a):
        k6_inputs.append(clone(a))
        return tr_fn(*a)

    def events_around(fn, events):
        def call(*a):
            e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
            e0.record()
            fn(*a)
            e1.record()
            events.append((e0, e1))
        return call

    def ms(ev):
        return ev[0].elapsed_time(ev[1])

    for name in W.launches:
        W.launches[name] = 0
    enc = default_encoder()
    dec = TD.TorchDecoder(device="cuda")
    def_launches = {"sad_grid": 0, "lf_wavefront": 0, "encode_wavefront": 0,
                    "trellis": 0}
    def_s = []
    EW.encode_recon_planes, EW._k5_launch = keep_ew, events_around(
        k5_fn, k5_events)
    TE._trellis_mbs, RD.k6_launch = keep_tr, events_around(k6_fn, k6_events)
    try:
        for i, frame in enumerate(src_frames[:DEFAULT_FRAMES]):
            want_k3 = refs_searched(enc) if i else 0
            before = dict(W.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = enc.encode_frame(*frame)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            def_s.append(secs)
            k3 = W.launches["sad_grid"] - before["sad_grid"]
            k2 = W.launches["lf_wavefront"] - before["lf_wavefront"]
            k5 = W.launches["encode_wavefront"] - before["encode_wavefront"]
            k6 = W.launches["trellis"] - before["trellis"]
            def_launches["sad_grid"] += k3
            def_launches["lf_wavefront"] += k2
            def_launches["encode_wavefront"] += k5
            def_launches["trellis"] += k6
            show, planes = dec.decode_frame(payload)
            recon = enc.ref_last.visible()
            p = psnr(frame[0], recon[0])
            n_intra, n_bpred, levels = frame_shape(enc)
            n_inter = enc.R * enc.C - n_intra
            print(f"encode 1080p default features frame {i} "
                  f"({'key' if i == 0 else 'inter'}): {len(payload)} bytes"
                  + (f" ({slice2_bytes[i]} under SLICE2_SF)"
                     if i < len(slice2_bytes) else "")
                  + f", luma PSNR {p:.2f} dB, intra MBs {n_intra}, B_PRED "
                  f"MBs {n_bpred}, inter MBs through the trellis {n_inter}, "
                  f"dependency levels {levels}, {secs:.4f} s, K5 in the "
                  f"encoder {ms(k5_events[-1]):.4f} ms"
                  + (f", K6 in the encoder {ms(k6_events[-1]):.4f} ms"
                     if k6 else "")
                  + f", K3 launches {k3}, K2 launches {k2}, K5 launches {k5}"
                  f", K6 launches {k6} [{card}]", flush=True)
            want_k6 = 1 if i and n_inter else 0
            if k3 != want_k3 or k2 != 1 or k5 != 1 or k6 != want_k6:
                fail(f"default-feature encode frame {i}: K3 launched {k3} "
                     f"times for {want_k3} references, K2 {k2} times for one "
                     f"loop filter, K5 {k5} times for one encode wavefront, "
                     f"K6 {k6} times for {want_k6} trellis")
            if len(payload) != DEFAULT_BYTES[i]:
                fail(f"default-feature encode frame {i}: {len(payload)} "
                     f"bytes, {DEFAULT_BYTES[i]} expected")
            if not show or any(not np.array_equal(a, b)
                               for a, b in zip(planes, recon)):
                fail(f"default-feature encode frame {i}: the decoded payload "
                     f"differs from the encoder's reconstruction")
            if p < 30.0:
                fail(f"default-feature encode frame {i}: luma PSNR {p:.2f} "
                     f"dB < 30 dB")
    finally:
        EW.encode_recon_planes, EW._k5_launch = ew_fn, k5_fn
        TE._trellis_mbs, RD.k6_launch = tr_fn, k6_fn
    for name, count in def_launches.items():
        launches[name] += count
    print(f"encode 1080p default features: "
          f"{(len(def_s) - 1) / sum(def_s[1:]):.4f} frames/s over "
          f"{len(def_s) - 1} inter frames, keyframe "
          f"{def_s[0]:.4f} s [{card}]", flush=True)

    # -- K5 vs plain at 1080p (the keyframe and inter frame 1 of that
    # encode), then K5's launch alone on every frame's inputs -------------
    k5_plain_ms = []
    for i in K5_PLAIN_FRAMES:
        a = k5_inputs[i]
        k5_vs_plain(torch, f"1080p default-feature frame {i}", a[0], a[1],
                    a[2:], {}, err, k5_plain_ms)
    print(f"K5 vs plain on 1080p default-feature frames {K5_PLAIN_FRAMES} "
          f"(0 the keyframe): all six outputs exact; plain "
          f"{[round(x, 1) for x in k5_plain_ms]} ms [{card}]", flush=True)
    plain_ms["k5"] = k5_plain_ms
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    k5_alone, k5_bounds, k5_steps = [], [], []
    for a in k5_inputs:
        (R5, C5, sy, su, sv, iy, iu, iv, mode, uv_mode, intra, d1, d2, du,
         qidx, ext, bcost, rdm, rdd, top) = a
        planes0, out0, intra_np, bpred_np = EW._frame_setup(
            R5, C5, (sy, su, sv), (iy, iu, iv), mode, intra,
            (d1, d2, du, qidx), ext, bcost, top)
        params = EW.pack_encode_params(mode, uv_mode, intra, d1, d2, du, qidx)
        rd = (bcost, rdm, rdd) if bcost is not None else (None,) * 3
        ts = []
        for _ in range(3):
            pl = [x.clone() for x in planes0]
            out = [x.clone() for x in out0]
            torch.cuda.synchronize()
            e0.record()
            EW._k5_launch(R5, C5, pl, out, (sy, su, sv), params, rd,
                          top is not None)
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        k5_alone.append(statistics.median(ts))
        # bytes: the intra flags and parameters of every MB, the sources
        # and the neighbours' pixels of the intra MBs read once; their
        # pixels, levels, eobs and B_PRED sub-modes written once. ops: ~40
        # integer operations per intra MB pixel or coefficient (predict,
        # transform, quantize, reconstruct), ~5 per pixel and sub-mode of a
        # B_PRED MB's pick
        ni, nb = int(intra_np.sum()), int(bpred_np.sum())
        byts = R5 * C5 * EW.ENC_COLS * 4 + ni * (384 * 4 + 71 + 384
                                                + 425 * 4) + nb * 16 * 4
        ops = ni * 384 * 40 + nb * 256 * 10 * 5
        k5_bounds.append((byts / HBM_BYTES_PER_S, ops / INT_OPS_PER_S))
        k5_steps.append(k5_chain(np, R5, C5, intra_np, bpred_np))
    k_ms["k5"] = statistics.mean(k5_alone)
    R5, C5 = k5_inputs[0][:2]
    if k5_steps[0] != R5 - 1 + C5 and not int((k5_inputs[0][8] ==
                                               W.B_PRED_M).sum()):
        fail(f"K5's chain on the all-16x16 keyframe is {k5_steps[0]} steps, "
             f"not (R-1)+C = {R5 - 1 + C5}")
    k5_enc = [x.elapsed_time(y) for x, y in k5_events]
    per_step = [round(a * 1e3 / b, 3) for a, b in zip(k5_alone[1:],
                                                      k5_steps[1:])]
    print(f"K5 encode_wavefront: {k_ms['k5']:.4f} ms/frame alone on each "
          f"default-feature 1080p frame's inputs (keyframe "
          f"{k5_alone[0]:.4f} ms, inter {[round(x, 4) for x in k5_alone[1:]]}"
          f" ms; {statistics.mean(k5_enc):.4f} ms/frame by events in the "
          f"encoder), 1 launch/frame; K5's chain of dependent MB steps "
          f"(k5_chain's model) {k5_steps[0]} on the keyframe, "
          f"{k5_alone[0] * 1e3 / k5_steps[0]:.3f} us/step, inter "
          f"{k5_steps[1:]}, {per_step} us/step; bound "
          f"{max(k5_bounds[0]) * 1e3:.4f} ms (keyframe) [{card}]", flush=True)
    del k5_inputs

    # -- K6 vs plain on that encode's inter frames 1 and 2, then K6's
    # launch alone on every inter frame's inputs --------------------------
    k6_plain_ms = []
    for i in (0, 1):
        k6_vs_plain(torch, f"1080p default-feature inter frame {i + 1}",
                    k6_inputs[i], err, k6_plain_ms)
    plain_ms["k6"] = k6_plain_ms
    # K6's launch alone is queued behind a ~50 us sleep kernel, so that
    # its events hold the kernel and not the host's launch path (a few us
    # of kernel against tens of us of Python and ctypes); from an idle
    # card, as K6 was timed before its redesign, for comparison
    k6_alone, k6_idle, k6_bounds, k6_ni = [], [], [], []
    for a in k6_inputs:
        ins = RD.k6_inputs(*a)
        out = (torch.empty_like(ins[0]), torch.empty_like(ins[2]))
        ts, ts_idle = [], []
        for _ in range(3):
            for queued, got in ((True, ts), (False, ts_idle)):
                torch.cuda.synchronize()
                if queued:
                    torch.cuda._sleep(100_000)
                e0.record()
                RD.k6_launch(ins, out)
                e1.record()
                torch.cuda.synchronize()
                got.append(e0.elapsed_time(e1))
        k6_alone.append(statistics.median(ts))
        k6_idle.append(statistics.median(ts_idle))
        # bytes: coefs, levels, eobs and dequantizers read once, levels and
        # eobs written once, the tables once; ops: ~60 integer and float
        # operations per backward step over the positions each block's
        # eob needs (i0 = 1 for Y), ~16 per block to load, find the eob,
        # walk forward and store
        ni = a[0].shape[0]
        k6_ni.append(ni)
        byts = ni * (2 * 1600 + 100 + 24 + 1600 + 100) + \
            3 * 576 * 4 + 3 * RD._N_VALUES + 8
        first = torch.cat([torch.ones(16, dtype=torch.int32),
                           torch.zeros(9, dtype=torch.int32)]).to(dev)
        steps = int((a[2] - first).clamp(min=0).sum())
        ops = steps * 60 + ni * 25 * 16
        k6_bounds.append((byts / HBM_BYTES_PER_S, ops / INT_OPS_PER_S))
    k_ms["k6"] = statistics.mean(k6_alone)
    k6_enc = [ms(x) for x in k6_events]
    print(f"K6 vs plain on 1080p default-feature inter frames 1 and 2: "
          f"levels and eobs exact; plain {k6_plain_ms[0]:.1f} / "
          f"{k6_plain_ms[1]:.1f} ms [{card}]", flush=True)
    print(f"K6 trellis: {k_ms['k6']:.4f} ms/frame alone on each "
          f"default-feature 1080p inter frame's inputs, queued behind a "
          f"sleep kernel ({[round(x, 4) for x in k6_alone]} ms at "
          f"{k6_ni} inter MBs; from an idle card "
          f"{statistics.mean(k6_idle):.4f} ms/frame, "
          f"{[round(x, 4) for x in k6_idle]}; "
          f"{statistics.mean(k6_enc):.4f} ms/frame by "
          f"events in the encoder), 1 launch/inter frame; bound "
          f"{[round(max(b) * 1e3, 4) for b in k6_bounds]} ms by "
          f"{'bytes' if k6_bounds[0][0] >= k6_bounds[0][1] else 'operations'}"
          f" [{card}]", flush=True)
    del k6_inputs

    # -- timed split of the default-feature encode: the B_PRED decision
    # candidate, the encode wavefront, K5 inside it and the trellis, each
    # synchronised -------------------------------------------------------
    split, stages = [], {}

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[key] = stages.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    probes = [(TE, "_bpred_rd", "bpred_decision"),
              (EW, "_k5_launch", "k5"),
              (TE, "_trellis_mbs", "trellis"),
              (EW, "encode_recon_planes", "encode_wavefront")]
    saved = [getattr(mod, attr) for mod, attr, _ in probes]
    for (mod, attr, key), fn in zip(probes, saved):
        setattr(mod, attr, timed(fn, key))
    try:
        enc = default_encoder()
        for frame in src_frames[:SPLIT_FRAMES]:
            stages.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc.encode_frame(*frame)
            torch.cuda.synchronize()
            split.append(dict(stages, total=time.perf_counter() - t0))
    finally:
        for (mod, attr, _), fn in zip(probes, saved):
            setattr(mod, attr, fn)
    for i, row in enumerate(split):
        print(f"default-feature split, frame {i}: " + ", ".join(
            f"{k} {row.get(k, 0.0):.4f} s" for k in (
                "total", "bpred_decision", "encode_wavefront", "k5",
                "trellis")) + f" [{card}]", flush=True)
    print(f"K6 beside the encode: {k6_alone[0]:.4f} ms alone on inter frame "
          f"1's inputs; the trellis stage (_trellis_mbs: K6 through its "
          f"wrapper) {split[1]['trellis']:.4f} s of that frame's "
          f"{split[1]['total']:.4f} s; the default-feature encode "
          f"{(len(def_s) - 1) / sum(def_s[1:]):.4f} frames/s [{card}]",
          flush=True)

    # -- multi-GPU: sharded decode and encode, GOP-parallel decode and
    # encode, the batch transcoder, on virtual shards of the one card ----
    for name, count in multi_shard_phases(torch, np, card, slice2_frames,
                                          slice2_payloads, err).items():
        launches[name] += count

    # -- the encoder's user entry points: tpuvpxenc and MultiResEncoder ----
    for name, count in cli_encode_phases(torch, np, card, src_frames,
                                         err).items():
        launches[name] += count

    # -- K4, the device detokenizer, and the port's headline bench ---------
    k4_launches, k4_entry = entropy_phases(torch, np, card)
    for name, count in k4_launches.items():
        launches[name] += count

    kernels = []
    for key, name, src, replaces, bs in (
            ("k1", "intra_wavefront", "libvpx_opencl_tpu_torch/csrc/"
             "intra_wavefront.cu", "libvpx_opencl_tpu/ops/pallas_wavefront.py"
             ":148", k1_bounds),
            ("k2", "lf_wavefront", "libvpx_opencl_tpu_torch/csrc/"
             "lf_wavefront.cu", "libvpx_opencl_tpu/ops/pallas_wavefront.py"
             ":407", k2_bounds),
            ("k3", "sad_grid", "libvpx_opencl_tpu_torch/csrc/sad_grid.cu",
             "libvpx_opencl_tpu/ops/me_pallas.py:48", k3_bounds),
            ("k5", "encode_wavefront", "libvpx_opencl_tpu_torch/csrc/"
             "encode_wavefront.cu", "libvpx_opencl_tpu/models/wavefront.py"
             ":253", k5_bounds),
            ("k6", "trellis", "libvpx_opencl_tpu_torch/csrc/trellis.cu",
             "libvpx_opencl_tpu/ops/rd_device.py:193", k6_bounds)):
        b_ms, b_by = bound(bs)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "max_abs_diff": err[name],
            "ms": k_ms[key], "plain_ms": statistics.mean(plain_ms[key]),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms.get(key),
            "card": card})
    kernels.append(k4_entry)
    kernels.append(k7_entry)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
          f"card check to here", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
