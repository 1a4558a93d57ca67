"""Cross-shard K1/K2 (libvpx_opencl_tpu_torch/parallel/sharded_wavefront.py)
vs the JAX whole-frame wavefronts, exact equality (integer math:
tolerance 0), and the launch counters under threads.

* Random R x C cases (every 16x16, chroma and B_PRED sub-mode, normal and
  simple loop filter) split into 2-3 row shards: each shard's planes go
  through the plain K1/K2 with `top_interior` and the halo copies
  (intra_sharded, filter_sharded on CPU tensors), and the reassembled
  frame equals libvpx_opencl_tpu.models.wavefront.intra_recon_blocks then
  loop_filter_blocks on the same seeded numpy inputs.
* ops/_cuda.count_launch keeps every increment under many threads, and
  the plain wrappers on CPU tensors, run from two threads, count nothing.
* On a card (cuda marker): K1 and K2 with top_interior equal their plain
  versions.
"""
import functools
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models import wavefront as wf
from libvpx_opencl_tpu_torch.ops import _cuda
from libvpx_opencl_tpu_torch.ops import wavefront as W
from libvpx_opencl_tpu_torch.parallel import sharded_wavefront as SW
from test_torch_wavefront import _intra_case, _lf_case, _t

torch.set_num_threads(1)
B, B2 = W.BORDER, W.BORDER // 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run by chip_smoke.py)")
    return torch.device("cuda")


def test_split_rows():
    assert SW.split_rows(9, 5) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 9)]
    assert SW.split_rows(9, 1) == [(0, 9)]
    assert SW.split_rows(4, 8) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert SW.split_rows(68, 4) == [(0, 17), (17, 34), (34, 51), (51, 68)]


def _shard(planes, rows, n_mb_cols):
    """Whole-frame bordered planes -> per-shard bordered planes holding
    the shard's rows (borders zero)."""
    out = []
    for r0, r1 in rows:
        shard = W.alloc_planes(r1 - r0, n_mb_cols, "cpu")
        for pl, full, n, b in zip(shard, planes, (16, 8, 8), (B, B2, B2)):
            pl.zero_()
            pl[b:b + (r1 - r0) * n] = full[b + r0 * n:b + r1 * n]
        out.append(shard)
    return out


def _blocks(shards, rows, C):
    """Per-shard planes -> whole-frame [N,16,16] / [N,8,8] blocks."""
    parts = [W.planes_to_blocks(r1 - r0, C, *pl)
             for pl, (r0, r1) in zip(shards, rows)]
    return [torch.cat([p[k] for p in parts]) for k in range(3)]


@pytest.mark.parametrize("R,C,S", [(5, 4, 2), (7, 3, 3), (4, 6, 3)])
@pytest.mark.parametrize("simple", [False, True])
def test_sharded_k1_k2_match_jax_wavefront(R, C, S, simple):
    rng = np.random.default_rng(R * 1000 + C * 10 + S)
    icase = _intra_case(rng, R, C)
    lcase = _lf_case(rng, R, C)
    sch = wf.schedule(R, C)
    want = jax.jit(functools.partial(wf.intra_recon_blocks, R, C, sch))(
        *[jnp.asarray(a) for a in icase])
    want = jax.jit(functools.partial(wf.loop_filter_blocks, R, C, sch,
                                     simple))(
        *want, *[jnp.asarray(a) for a in lcase[3:]])

    t = [_t(a) for a in icase]
    planes = W.blocks_to_planes(R, C, *t[:3])
    resid = [x.to(torch.int32).contiguous() for x in t[3:6]]
    iparams = W.pack_intra_params(*t[6:])
    lparams = W.pack_lf_params(*[_t(a) for a in lcase[3:]])
    rows = SW.split_rows(R, S)
    assert len(rows) == S
    shards = _shard(planes, rows, C)
    streams = [None] * S
    taken = SW.intra_sharded(
        shards, streams, [[x[r0 * C:r1 * C] for x in resid]
                          for r0, r1 in rows],
        [iparams[r0 * C:r1 * C] for r0, r1 in rows])
    SW.filter_sharded(shards, streams,
                      [lparams[r0 * C:r1 * C] for r0, r1 in rows], simple,
                      taken)
    for g, w in zip(_blocks(shards, rows, C), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_count_launch_keeps_every_increment_under_threads():
    saved = dict(_cuda.launches)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                _cuda.count_launch("sad_grid")
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        assert _cuda.launches["sad_grid"] == saved["sad_grid"] + 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        _cuda.launches.update(saved)


def test_plain_wrappers_on_two_threads_count_nothing():
    """Two threads run K1 and K2 (with and without top_interior) on CPU
    tensors: the plain versions run, the results equal a run on one
    thread, and the launch counts stay put."""
    R, C = 3, 4
    icase = [_t(a) for a in _intra_case(np.random.default_rng(11), R, C)]
    lcase = [_t(a) for a in _lf_case(np.random.default_rng(12), R, C)]

    def work(top):
        y, u, v = W.blocks_to_planes(R, C, *icase[:3])
        for pl, b in zip((y, u, v), (B, B2, B2)):
            pl[:b] = 77
        W.intra_recon_planes(R, C, y, u, v,
                             *[x.to(torch.int32).contiguous()
                               for x in icase[3:6]],
                             W.pack_intra_params(*icase[6:]),
                             top_interior=top)
        W.loop_filter_planes(R, C, False, y, u, v,
                             W.pack_lf_params(*lcase[3:]), top_interior=top)
        return y, u, v

    want = {top: work(top) for top in (False, True)}
    before = dict(W.launches)
    got = {}
    threads = [threading.Thread(target=lambda t=top: got.update({t: work(t)}))
               for top in (False, True)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert W.launches == before
    for top in (False, True):
        for g, w in zip(got[top], want[top]):
            assert torch.equal(g, w)
    # the flag changes row 0 (the border holds 77s, not the frame edge)
    assert not torch.equal(want[True][0], want[False][0])


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(3, 5), (1, 1), (17, 120)])
def test_top_interior_kernels_match_plain_on_card(cuda_device, R, C):
    """K1 and K2 with top_interior on a shard geometry with a filled top
    border equal their plain versions (chip_smoke.py runs the same check
    at 17 x 120)."""
    dev = cuda_device
    rng = np.random.default_rng(R * 100 + C)
    icase = [_t(a).to(dev) for a in _intra_case(rng, R, C)]
    lcase = [_t(a).to(dev) for a in _lf_case(rng, R, C)]
    planes = W.blocks_to_planes(R, C, *icase[:3])
    for pl, b in zip(planes, (B, B2, B2)):
        pl[:b] = torch.from_numpy(rng.integers(0, 256, (b, pl.shape[1]))
                                  .astype(np.uint8)).to(dev)
    resid = [x.to(torch.int32).contiguous() for x in icase[3:6]]
    ip = W.pack_intra_params(*icase[6:])
    lp = W.pack_lf_params(*lcase[3:])
    for simple in (False, True):
        got = [p.clone() for p in planes]
        want = [p.clone() for p in planes]
        W.intra_recon_planes(R, C, *got, *resid, ip, top_interior=True)
        W._intra_planes_plain(R, C, *want, *resid, ip, top_interior=True)
        W.loop_filter_planes(R, C, simple, *got, lp, top_interior=True)
        W._lf_planes_plain(R, C, simple, *want, lp, top_interior=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
