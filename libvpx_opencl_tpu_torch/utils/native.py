"""ctypes binding + on-demand build of the native host entropy runtime
(csrc/host/vp8_entropy.cpp: mode/MV decode and detokenize;
csrc/host/vp8_pack.cpp and vp8_pack_modes.cpp: the encoder's token and
mode packing, MV->mode mapping and branch counting).

The shared library is compiled with g++ (-O3 -march=native, as the JAX
package builds its copy) on first use into the package's own build
directory (`_build/`, not committed: it is built for the machine it runs
on). There is no pure-Python fallback behind `get_lib`: a decoder that
asks for the native runtime gets it or an error.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc", "host")
_SRCS = [os.path.join(_SRC_DIR, "vp8_entropy.cpp"),
         os.path.join(_SRC_DIR, "vp8_pack.cpp"),
         os.path.join(_SRC_DIR, "vp8_pack_modes.cpp")]
_DEPS = _SRCS + [os.path.join(_SRC_DIR, "vp8_tables.h")]
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SO = os.path.join(BUILD_DIR, "libvp8entropy.so")

_lib = None
_lock = threading.Lock()


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent test workers may
    # build at the same time and must never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-o", tmp] + _SRCS,
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SO} failed:\n{proc.stderr}")
    os.replace(tmp, _SO)


def get_lib():
    """Load the native library, building it first if it is missing or
    older than its sources. Raises RuntimeError if it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < max(os.path.getmtime(s)
                                                   for s in _DEPS)):
                _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native entropy runtime unavailable: {e}") \
                from e
        i64 = ctypes.POINTER(ctypes.c_int64)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i16 = ctypes.POINTER(ctypes.c_int16)
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.vp8e_decode_modes.restype = ctypes.c_int
        lib.vp8e_decode_modes.argtypes = [
            u8, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8, u8, u8, u8, u8, i32,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            u8, i64]
        lib.vp8e_detokenize.restype = ctypes.c_int
        lib.vp8e_detokenize.argtypes = [
            u8, i64, i64, ctypes.c_int, u8, ctypes.c_int, ctypes.c_int,
            i32, i32, i16, i32]
        lib.vp8e_count_tokens.restype = ctypes.c_int
        lib.vp8e_count_tokens.argtypes = [
            i16, i32, i32, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int, i64]
        lib.vp8e_pack_tokens.restype = ctypes.c_int64
        lib.vp8e_pack_tokens.argtypes = [
            i16, i32, i32, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8, ctypes.c_int, u8, ctypes.c_int64, i64]
        ci = ctypes.c_int
        lib.vp8e_map_mv_modes.restype = ci
        lib.vp8e_map_mv_modes.argtypes = [
            ci, ci, i32, i32, i32, i32, i32, i32, i32]
        lib.vp8e_count_modes.restype = ci
        lib.vp8e_count_modes.argtypes = [
            ci, ci, i32, i32, i32, i32, i32, i32, i32, i32, i64, i64, i64]
        lib.vp8e_pack_modes.restype = ctypes.c_int64
        lib.vp8e_pack_modes.argtypes = [
            ci, ci, ci, i32, i32, i32, i32, i32, i32, i32, i32, i32, ci, u8,
            ci, ci, ci, ci, ci, u8, u8, u8, u8, ctypes.c_int64, i64]
        _lib = lib
        return _lib


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def decode_modes_native(lib, bc, dec):
    """Run mode/MV decode in C++ starting from BoolDecoder `bc`'s state;
    fills dec.* grids and advances bc."""
    R, C = dec.mb_rows, dec.mb_cols
    ymode = dec.fc.ymode_prob.astype(np.uint8)
    uvmode = dec.fc.uv_mode_prob.astype(np.uint8)
    bmode_p = dec.fc.bmode_prob.astype(np.uint8)
    mvc = np.ascontiguousarray(dec.fc.mvc.astype(np.uint8))
    segp = dec.mb_segment_tree_probs.astype(np.uint8)
    sign_bias = np.asarray(dec.sign_bias, dtype=np.int32)
    out_probs = np.zeros(4, np.uint8)
    out_state = np.zeros(4, np.int64)
    buf = np.frombuffer(bc.buf, dtype=np.uint8)
    segmap = np.ascontiguousarray(dec.seg_map.astype(np.int32))
    lib.vp8e_decode_modes(
        _p(buf, ctypes.c_uint8), len(bc.buf), bc.pos,
        ctypes.c_uint64(bc.value), bc.count, bc.range,
        dec.frame_type, R, C, dec.mb_no_coeff_skip,
        dec.update_mb_seg_map,
        _p(segp, ctypes.c_uint8), _p(ymode, ctypes.c_uint8),
        _p(uvmode, ctypes.c_uint8), _p(bmode_p, ctypes.c_uint8),
        _p(mvc, ctypes.c_uint8), _p(sign_bias, ctypes.c_int32),
        _p(dec.mode, ctypes.c_int32), _p(dec.ref_frame, ctypes.c_int32),
        _p(dec.mv, ctypes.c_int32), _p(dec.bmode, ctypes.c_int32),
        _p(dec.bmv, ctypes.c_int32), _p(dec.uv_mode, ctypes.c_int32),
        _p(dec.skip, ctypes.c_int32), _p(dec.partitioning, ctypes.c_int32),
        _p(dec.need_clamp, ctypes.c_int32), _p(segmap, ctypes.c_int32),
        _p(out_probs, ctypes.c_uint8), _p(out_state, ctypes.c_int64))
    dec.fc.ymode_prob[:] = ymode
    dec.fc.uv_mode_prob[:] = uvmode
    dec.fc.mvc[:] = mvc.reshape(2, 19)
    dec.seg_map[:] = segmap
    dec.prob_skip_false = int(out_probs[0])
    dec.prob_intra = int(out_probs[1])
    dec.prob_last = int(out_probs[2])
    dec.prob_gf = int(out_probs[3])
    bc.pos = int(out_state[0])
    bc.value = int(np.uint64(out_state[1]))
    bc.count = int(out_state[2])
    bc.range = int(out_state[3])


def detokenize_native(lib, dec):
    """Whole-frame token decode in C++; fills dec.qcoeff/dec.eobs and
    updates dec.skip (eobtotal==0 rule)."""
    R, C = dec.mb_rows, dec.mb_cols
    N = R * C
    parts = dec.part_bytes
    data = b"".join(parts)
    buf = np.frombuffer(data, dtype=np.uint8)
    offs = np.zeros(len(parts), np.int64)
    sizes = np.zeros(len(parts), np.int64)
    o = 0
    for i, p in enumerate(parts):
        offs[i] = o
        sizes[i] = len(p)
        o += len(p)
    cp = np.ascontiguousarray(dec.fc.coef_probs.astype(np.uint8))
    qcoeff = np.zeros((N, 25, 16), np.int16)
    eobs = np.zeros((N, 25), np.int32)
    lib.vp8e_detokenize(
        _p(buf, ctypes.c_uint8), _p(offs, ctypes.c_int64),
        _p(sizes, ctypes.c_int64), len(parts), _p(cp, ctypes.c_uint8),
        R, C, _p(dec.mode, ctypes.c_int32), _p(dec.skip, ctypes.c_int32),
        _p(qcoeff, ctypes.c_int16), _p(eobs, ctypes.c_int32))
    # int16 end-to-end: the device widens to int32 itself
    dec.qcoeff = qcoeff.reshape(R, C, 25, 16)
    dec.eobs = eobs.reshape(R, C, 25)


def count_tokens_native(lib, qcoeff16, eobs, modes, skip,
                        mb_no_coeff_skip):
    """Whole-frame token branch counting in C++ (the _count_tokens role).

    qcoeff16 [R,C,25,16] i16 contiguous; eobs [R,C,25] i32; modes [R,C]
    i32 (per-MB ymode incl. B_PRED=4/SPLITMV=9); skip [R,C] i32.
    Returns counts [4,8,3,11,2] int64."""
    R, C = modes.shape
    counts = np.zeros((4, 8, 3, 11, 2), np.int64)
    lib.vp8e_count_tokens(
        _p(qcoeff16, ctypes.c_int16), _p(eobs, ctypes.c_int32),
        _p(modes, ctypes.c_int32), _p(skip, ctypes.c_int32),
        R, C, int(mb_no_coeff_skip), _p(counts, ctypes.c_int64))
    return counts


def pack_tokens_native(lib, qcoeff16, eobs, modes, skip, mb_no_coeff_skip,
                       coef_probs, nparts):
    """Whole-frame token packing in C++ (vp8_pack_tokens_into_partitions
    role).  Returns the list of per-partition byte strings, or None if
    the output buffer overflowed (caller falls back to Python)."""
    R, C = modes.shape
    cap = int(qcoeff16.size * 2 + 4096 * nparts)
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(nparts, np.int64)
    cp = np.ascontiguousarray(coef_probs.astype(np.uint8))
    total = lib.vp8e_pack_tokens(
        _p(qcoeff16, ctypes.c_int16), _p(eobs, ctypes.c_int32),
        _p(modes, ctypes.c_int32), _p(skip, ctypes.c_int32),
        R, C, int(mb_no_coeff_skip), _p(cp, ctypes.c_uint8), nparts,
        _p(out, ctypes.c_uint8), cap, _p(sizes, ctypes.c_int64))
    if total < 0:
        return None
    parts = []
    off = 0
    for p in range(nparts):
        n = int(sizes[p])
        parts.append(out[off:off + n].tobytes())
        off += n
    return parts


def _mode_grids(enc):
    """Contiguous int32 views of the encoder's padded mode grids (zeros
    where a path never populates them, e.g. bmv on the device encoder)."""
    R, C = enc.R, enc.C
    z_bmv = np.zeros((R + 1, C + 1, 16, 2), np.int32)
    z_sp = np.zeros((R, C), np.int32)
    g = dict(
        mode=np.ascontiguousarray(enc.mode.astype(np.int32)),
        reff=np.ascontiguousarray(enc.reff.astype(np.int32)),
        mv=np.ascontiguousarray(enc.mv.astype(np.int32)),
        bmode=np.ascontiguousarray(enc.bmode.astype(np.int32)),
        bmv=np.ascontiguousarray(
            getattr(enc, "bmv", z_bmv).astype(np.int32)),
        split_part=np.ascontiguousarray(
            getattr(enc, "split_part", z_sp).astype(np.int32)),
        skip=np.ascontiguousarray(enc.skip.astype(np.int32)),
        uvmode=np.ascontiguousarray(enc.uvmode.astype(np.int32)),
    )
    return g


def map_mv_modes_native(lib, enc):
    """Exact near-MV-lattice MV->mode mapping for all inter MBs in C++
    (replaces the per-MB Python _find_near loop); updates enc.mode."""
    g = _mode_grids(enc)
    lib.vp8e_map_mv_modes(
        enc.R, enc.C, _p(g["mode"], ctypes.c_int32),
        _p(g["reff"], ctypes.c_int32), _p(g["mv"], ctypes.c_int32),
        _p(g["bmode"], ctypes.c_int32), _p(g["bmv"], ctypes.c_int32),
        _p(g["split_part"], ctypes.c_int32), _p(g["skip"], ctypes.c_int32))
    enc.mode[:] = g["mode"]


def count_modes_native(lib, enc):
    """Dry mode-section counting pass in C++.  Returns (ymode_ct[5],
    uv_ct[4], mvstats) with mvstats in the encoder's dict-of-lists
    format."""
    g = _mode_grids(enc)
    ymode_ct = np.zeros(5, np.int64)
    uv_ct = np.zeros(4, np.int64)
    flat = np.zeros(2 * 32, np.int64)
    rc = lib.vp8e_count_modes(
        enc.R, enc.C, _p(g["mode"], ctypes.c_int32),
        _p(g["reff"], ctypes.c_int32), _p(g["mv"], ctypes.c_int32),
        _p(g["bmode"], ctypes.c_int32), _p(g["bmv"], ctypes.c_int32),
        _p(g["split_part"], ctypes.c_int32), _p(g["skip"], ctypes.c_int32),
        _p(g["uvmode"], ctypes.c_int32),
        _p(ymode_ct, ctypes.c_int64), _p(uv_ct, ctypes.c_int64),
        _p(flat, ctypes.c_int64))
    if rc == -2:
        raise ValueError("an MV delta is odd: VP8 codes MVs in quarter "
                         "pels (even 1/8 units)")
    mvstats = []
    for comp in range(2):
        o = flat[comp * 32:(comp + 1) * 32]
        mvstats.append({
            "sign": [int(o[0]), int(o[1])],
            "short_flag": [int(o[2]), int(o[3])],
            "short": [int(x) for x in o[4:12]],
            "bits": [[int(o[12 + 2 * k]), int(o[12 + 2 * k + 1])]
                     for k in range(10)],
        })
    return ymode_ct, uv_ct, mvstats


def pack_modes_native(lib, enc, first, keyframe):
    """Real mode-section pack in C++, continuing BoolEncoder `first`'s
    in-progress partition-0 stream.  Returns True on success (first's
    state advanced), False to fall back to Python (the buffer would
    overflow); raises ValueError on an odd MV delta."""
    g = _mode_grids(enc)
    R, C = enc.R, enc.C
    cap = len(first.buf) + (R + 1) * (C + 1) * 64 + 65536
    buf = np.zeros(cap, np.uint8)
    buf[:len(first.buf)] = np.frombuffer(bytes(first.buf), np.uint8)
    state = np.array([first.lowvalue, first.range, first.count,
                      len(first.buf)], np.int64)
    seg_enabled = getattr(enc, "seg_map_enc", None) is not None
    if seg_enabled:
        segmap = np.ascontiguousarray(enc.seg_map_enc.astype(np.int32))
        segp = np.asarray(enc.seg_tree_probs, np.uint8)
    else:
        segmap = np.zeros((R, C), np.int32)
        segp = np.zeros(3, np.uint8)
    ymp = np.asarray(enc.ymode_prob, np.uint8)
    uvp = np.asarray(enc.uv_mode_prob, np.uint8)
    mvc = np.ascontiguousarray(enc.mvc.astype(np.uint8))
    rc = lib.vp8e_pack_modes(
        R, C, int(keyframe), _p(g["mode"], ctypes.c_int32),
        _p(g["reff"], ctypes.c_int32), _p(g["mv"], ctypes.c_int32),
        _p(g["bmode"], ctypes.c_int32), _p(g["bmv"], ctypes.c_int32),
        _p(g["split_part"], ctypes.c_int32), _p(g["skip"], ctypes.c_int32),
        _p(g["uvmode"], ctypes.c_int32), _p(segmap, ctypes.c_int32),
        int(seg_enabled), _p(segp, ctypes.c_uint8),
        int(enc.mb_no_coeff_skip), int(getattr(enc, "prob_skip_false", 0)),
        int(getattr(enc, "prob_intra", 0)),
        int(getattr(enc, "prob_last", 0)), int(getattr(enc, "prob_gf", 0)),
        _p(ymp, ctypes.c_uint8), _p(uvp, ctypes.c_uint8),
        _p(mvc, ctypes.c_uint8), _p(buf, ctypes.c_uint8), cap,
        _p(state, ctypes.c_int64))
    if rc == -2:
        raise ValueError("an MV delta is odd: VP8 codes MVs in quarter "
                         "pels (even 1/8 units)")
    if rc < 0:
        return False
    first.lowvalue = int(state[0])
    first.range = int(state[1])
    first.count = int(state[2])
    first.buf = bytearray(buf[:int(state[3])].tobytes())
    return True
