"""ctypes binding + on-demand build of the native host entropy runtime
(csrc/host/vp8_entropy.cpp: mode/MV decode and detokenize).

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
_SRCS = [os.path.join(_SRC_DIR, "vp8_entropy.cpp")]
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
