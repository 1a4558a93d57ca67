"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled on first use with `nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC` into its own
shared library under the package's `_build/` directory (not committed),
all sources in parallel, and bound through ctypes with a plain C
interface: device pointers, sizes and the stream go in as c_void_p /
c_int, and each entry point returns cudaGetLastError().

Nothing here runs at import: a machine without nvcc or a card can import
every module of the package, and nvcc runs only when a kernel is first
launched (or `load()` is called).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
# kernel name -> (source, C entry point, argtypes)
KERNELS = {
    "intra_wavefront": ("intra_wavefront.cu", "intra_wavefront",
                        [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I,
                         _I, _I, _VP, _VP]),
    "lf_wavefront": ("lf_wavefront.cu", "lf_wavefront",
                     [_VP, _I, _VP, _VP, _I, _VP, _I, _I, _I, _I, _I, _VP,
                      _VP]),
    "sad_grid": ("sad_grid.cu", "sad_grid",
                 [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
                  _VP]),
    "detokenize": ("detokenize.cu", "detokenize",
                   [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                    _I, _I, _VP]),
    "encode_wavefront": ("encode_wavefront.cu", "encode_wavefront",
                         [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                          _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP]),
    "trellis": ("trellis.cu", "trellis", [_VP] * 13 + [_I, _VP, _VP, _VP]),
    "inter_recon": ("inter_recon.cu", "inter_recon",
                    [_VP] + [_I] * 7 + [_VP, _VP, _I, _VP, _VP, _VP, _I,
                                        _VP, _VP, _VP, _VP, _VP, _VP, _I,
                                        _VP, _VP, _I, _I, _I, _VP]),
}

#: kernel launches made by the wrappers, per kernel; a wrapper adds to its
#: count only where it launches its kernel, through `count_launch`
launches = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()

_fns = None
_lock = threading.Lock()
#: nvcc's -Xptxas -v report per kernel, from the last build
ptxas_report = {}


def _nvcc():
    exe = shutil.which("nvcc")
    if exe is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME:
            exe = os.path.join(CUDA_HOME, "bin", "nvcc")
    if exe is None or not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _so_path(name):
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name):
    """True if the library is missing or older than its source or any
    header in csrc/."""
    so = _so_path(name)
    deps = [os.path.join(CSRC, KERNELS[name][0])] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return not os.path.exists(so) or os.path.getmtime(so) < \
        max(os.path.getmtime(f) for f in deps)


def _build(names):
    """Run one nvcc per source, all at once; raise with the compiler's
    output if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        src = os.path.join(CSRC, KERNELS[name][0])
        tmp = f"{_so_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        ptxas_report[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {KERNELS[name][0]}:\n{out}")
        else:
            os.replace(tmp, _so_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))


def load():
    """Build (if stale) and bind every kernel; returns {name: C function}.
    Raises RuntimeError if nvcc is missing or a build fails."""
    global _fns
    with _lock:
        if _fns is not None:
            return _fns
        stale = [n for n in KERNELS if _stale(n)]
        if stale:
            _build(stale)
        fns = {}
        for name, (_src, entry, argtypes) in KERNELS.items():
            fn = getattr(ctypes.CDLL(_so_path(name)), entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _fns = fns
        return _fns


def check(rc, name):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {rc}")


def count_launch(name):
    """Add one to `launches[name]`; safe from several threads (the GOP
    and stream-parallel drivers launch kernels from one thread each)."""
    with _count_lock:
        launches[name] += 1
