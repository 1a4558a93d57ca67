"""libvpx.opencl → TPU, ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside the JAX one (libvpx_opencl_tpu, the reference):
the same layout and module names where a counterpart exists, PyTorch for
the plain tensor code, hand-written CUDA kernels (csrc/) for what the JAX
package wrote in Pallas for the TPU. It imports nothing of JAX or of the
JAX package; the host modules it needs are its own copies.

  api.py   — the codec API: CodecDecoder (postproc, error concealment,
             input fragments, reference controls) and CodecEncoder
  cli/     — tpuvpxdec (decoder CLI on TorchDecoder) and tpuvpxenc
             (encoder CLI on TorchEncoder); --golden selects the host
             decoder / Encoder
  utils/   — IVF, WebM and Y4M containers, MD5 conformance oracle, native
             entropy and pack runtime
  ops/     — tables, transforms and quantizers, prediction, loop-filter
             math, motion search, RD costing, the K1/K2 wavefront and K3
             SAD-grid wrappers and their CUDA loader; the encoder's
             analysis ops (torch), display postproc and bicubic scaling
             (NumPy)
  models/  — bool coder, RefDecoder host entropy layer, TorchDecoder; host
             Encoder with its RD tables, rate control, two-pass, ARNR,
             lookahead, temporal layers and multi-resolution simulcast,
             the bool encoder, the encode wavefront, TorchEncoder
  parallel/ — multi-GPU: meshes of shards (shard i on card i % cards),
             the MB-row-sharded decoder and encoder, GOP-parallel decode
             and encode, the checkpointed batch transcoder
  csrc/    — CUDA kernels (built with nvcc on first use) and the host C++
             entropy and pack runtime (built with g++ on first use)

Entry points run on the CUDA card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
