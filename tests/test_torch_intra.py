"""Port K1 plain version vs the JAX intra wavefront, exact equality.

The same numpy inputs (made from a seed, every 16x16, chroma and B_PRED
sub-mode) go through libvpx_opencl_tpu.models.wavefront.intra_recon_blocks
(the golden XLA wavefront, itself MD5-verified) and through the port's
intra_recon_plain, at the four geometries of tests/test_pallas_decode.py.
Integer math: tolerance 0. On CPU tensors the public wrapper intra_recon
runs the plain version and must agree too.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models import wavefront as wf
from libvpx_opencl_tpu_torch.ops import wavefront as W
from test_torch_wavefront import GEOMS, _intra_case, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("R,C", GEOMS)
def test_intra_recon_plain_matches_jax(R, C):
    case = _intra_case(np.random.default_rng(R * 31 + C), R, C)
    want = jax.jit(functools.partial(wf.intra_recon_blocks, R, C,
                                     wf.schedule(R, C)))(
        *[jnp.asarray(a) for a in case])
    got = W.intra_recon_plain(R, C, *[_t(a) for a in case])
    wrapped = W.intra_recon(R, C, *[_t(a) for a in case])
    for w, g, g2 in zip(want, got, wrapped):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(w))
