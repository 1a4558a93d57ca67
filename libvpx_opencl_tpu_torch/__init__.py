"""libvpx.opencl → TPU, ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside the JAX one (libvpx_opencl_tpu, the reference):
the same layout and module names where a counterpart exists, PyTorch for
the plain tensor code, hand-written CUDA kernels (csrc/) for what the JAX
package wrote in Pallas for the TPU. It imports nothing of JAX or of the
JAX package; the host modules it needs are its own copies.

  utils/   — IVF container, MD5 conformance oracle, native entropy runtime
  ops/     — tables, transforms, prediction, loop-filter math, the K1/K2
             wavefront wrappers and their CUDA loader
  models/  — bool decoder, RefDecoder host entropy layer, TorchDecoder
  csrc/    — CUDA kernels (built with nvcc on first use) and the host C++
             entropy runtime (built with g++ on first use)

Entry points run on the CUDA card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
