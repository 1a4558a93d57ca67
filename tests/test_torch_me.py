"""Port motion estimation vs the JAX package, exact equality (integer
math, tolerance 0).

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart in libvpx_opencl_tpu_torch (ops/me.py,
ops/me_sad.py):
  * K3's plain version sad_grid_plain vs the Pallas kernel
    sad_grid_pallas in interpret mode and vs the XLA grid of ops/me.py,
    on windows gathered from the same plane;
  * full_search at step 1 and 2, with and without the MV-rate penalty,
    on a random and on a constant plane (ties: first index wins);
  * subpel_refine, near_mv_lattice (also vs the host Encoder's
    _find_near), intra_mode_preds / intra_mode_costs at 16 and 8.
On the CPU the wrapper sad_grid runs the plain version; the kernel itself
is held against it on a card (cuda marker) at rng 16, 7 and 1 and with
odd window columns. Both versions refuse source values outside [0, 255].
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.models import rdopt as jrdopt
from libvpx_opencl_tpu.ops import me as JME
from libvpx_opencl_tpu.ops import me_pallas
from libvpx_opencl_tpu.ops import predict as JP
from libvpx_opencl_tpu_torch.models.encoder import Encoder
from libvpx_opencl_tpu_torch.models.refdec import LAST_FRAME, NEWMV
from libvpx_opencl_tpu_torch.ops import _cuda
from libvpx_opencl_tpu_torch.ops import me as TME
from libvpx_opencl_tpu_torch.ops import me_sad
from libvpx_opencl_tpu_torch.ops import tables as TT

torch.set_num_threads(1)
B = 32
RNG = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _search_case(R, C, seed, const=False):
    """A bordered plane, source blocks, pre-clamped centres (as
    TorchEncoder.encode_frame makes them) and MB positions."""
    rng = np.random.default_rng(seed)
    N = R * C
    shape = (R * 16 + 2 * B, C * 16 + 2 * B)
    if const:
        plane = np.full(shape, 77, np.uint8)
        src = np.full((N, 16, 16), 77, np.int32)
    else:
        plane = rng.integers(0, 256, shape).astype(np.uint8)
        src = rng.integers(0, 256, (N, 16, 16)).astype(np.int32)
    mbr, mbc = np.arange(N) // C, np.arange(N) % C
    mb_pos = np.stack([B + mbr * 16, B + mbc * 16], 1).astype(np.int32)
    lo = np.stack([-(mbr * 16) - 16, -(mbc * 16) - 16], 1)
    hi = np.stack([(R - 1 - mbr) * 16 + 16, (C - 1 - mbc) * 16 + 16], 1)
    prev = rng.integers(-300, 300, (N, 2)).astype(np.int32)
    centers = np.clip(prev >> 3, lo, hi).astype(np.int32)
    bounds = [((-(mbr * 16) - 16) * 8), (((R - 1 - mbr) * 16 + 16) * 8),
              ((-(mbc * 16) - 16) * 8), (((C - 1 - mbc) * 16 + 16) * 8)]
    return dict(plane=plane, src=src, mb_pos=mb_pos, centers=centers,
                prev=prev, bounds=[b.astype(np.int32) for b in bounds],
                wy=mb_pos[:, 0] + centers[:, 0] - RNG,
                wx=mb_pos[:, 1] + centers[:, 1] - RNG)


MVCOST = np.stack([jrdopt.MV_COST[0], jrdopt.MV_COST[1]]).astype(np.int32)


def test_sad_grid_plain_matches_pallas_and_xla_grid():
    """N = 48, seed 0: the case of tests/test_me_pallas.py, with the
    windows gathered from one plane."""
    c = _search_case(6, 8, 0)
    N, W = 48, 2 * RNG + 16
    got = me_sad.sad_grid(_t(c["plane"]), _t(c["wy"]), _t(c["wx"]),
                          _t(c["src"]))
    assert got.dtype == torch.int32 and tuple(got.shape) == (N, 33, 33)
    a = np.arange(W)
    win = c["plane"][(c["wy"][:, None] + a)[:, :, None],
                     (c["wx"][:, None] + a)[:, None, :]].astype(np.int32)
    win_j, src_j = jnp.asarray(win), jnp.asarray(c["src"])
    _eq(got, me_pallas.sad_grid_pallas(win_j, src_j, RNG, interpret=True))
    cands = list(range(-RNG, RNG + 1))
    rows = []
    for dy in cands:
        strip = win_j[:, dy + RNG:dy + RNG + 16, :]
        cols = jnp.stack([strip[:, :, dx + RNG:dx + RNG + 16]
                          for dx in cands], axis=1)
        rows.append(jnp.sum(jnp.abs(cols - src_j[:, None]), axis=(2, 3)))
    _eq(got, jnp.stack(rows, axis=1))


def test_sad_grid_counts_no_launch_on_cpu_and_rejects_bad_windows():
    c = _search_case(3, 3, 1)
    before = _cuda.launches["sad_grid"]
    me_sad.sad_grid(_t(c["plane"]), _t(c["wy"]), _t(c["wx"]), _t(c["src"]))
    assert _cuda.launches["sad_grid"] == before
    for fn in (me_sad.sad_grid, me_sad.sad_grid_plain):
        bad = c["wy"].copy()
        bad[4] = c["plane"].shape[0] - 47          # one row too low
        with pytest.raises(ValueError, match="leaves"):
            fn(_t(c["plane"]), _t(bad), _t(c["wx"]), _t(c["src"]))
        bad = c["wx"].copy()
        bad[0] = -1
        with pytest.raises(ValueError, match="leaves"):
            fn(_t(c["plane"]), _t(c["wy"]), _t(bad), _t(c["src"]))
        with pytest.raises(ValueError, match="int32"):
            fn(_t(c["plane"]), _t(c["wy"]), _t(c["wx"]),
               _t(c["src"].astype(np.int64)))


def test_sad_grid_rejects_source_values_outside_bytes():
    """The kernel packs source pixels into bytes: both versions refuse a
    value it could not hold."""
    c = _search_case(3, 3, 1)
    for fn in (me_sad.sad_grid, me_sad.sad_grid_plain):
        for v in (-1, 256):
            src = c["src"].copy()
            src[4, 7, 9] = v
            with pytest.raises(ValueError, match=r"\[0, 255\]"):
                fn(_t(c["plane"]), _t(c["wy"]), _t(c["wx"]), _t(src))


@pytest.fixture(scope="module")
def searched():
    """JAX and port full_search results per (const, step, pen), on one
    4 x 6 case each for a random and a constant plane."""
    out = {}
    for const in (False, True):
        c = _search_case(4, 6, 2, const)
        j = jnp.asarray
        for step in (1, 2):
            for pen in (False, True):
                jp = (j(MVCOST), j(c["prev"]), jnp.int32(5)) if pen else None
                tp = (_t(MVCOST), _t(c["prev"]), 5) if pen else None
                want = JME.full_search(j(c["plane"]), j(c["src"]),
                                       j(c["centers"]), j(c["mb_pos"]),
                                       mv_pen=jp, step=step)
                got = TME.full_search(_t(c["plane"]), _t(c["src"]),
                                      _t(c["centers"]), _t(c["mb_pos"]),
                                      mv_pen=tp, step=step)
                out[const, step, pen] = (c, got, want)
    return out


@pytest.mark.parametrize("pen", [False, True])
@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("const", [False, True])
def test_full_search_matches_jax(searched, const, step, pen):
    c, (mv, sad), (mv_j, sad_j) = searched[const, step, pen]
    assert mv.dtype == torch.int32 and sad.dtype == torch.int32
    _eq(mv, mv_j)
    _eq(sad, sad_j)
    if const and not pen:
        # every offset ties at SAD 0: the first index of the flattened
        # grid wins, i.e. (-16, -16) from the centre
        np.testing.assert_array_equal(mv.numpy(), c["centers"] - RNG)
        assert int(sad.abs().max()) == 0


@pytest.mark.parametrize("pen", [False, True])
def test_subpel_refine_matches_jax(searched, pen):
    c, (mv, sad), (mv_j, sad_j) = searched[False, 1, pen]
    j = jnp.asarray
    taps = np.asarray(JP.SIXTAP_TABLE, np.int32)
    jp = (j(MVCOST), j(c["prev"]), jnp.int32(5)) if pen else None
    tp = (_t(MVCOST), _t(c["prev"]), 5) if pen else None
    want = JME.subpel_refine(j(c["plane"]), j(c["src"]), j(c["mb_pos"]),
                             mv_j, sad_j, j(taps),
                             tuple(j(b) for b in c["bounds"]), mv_pen=jp)
    got = TME.subpel_refine(_t(c["plane"]), _t(c["src"]), _t(c["mb_pos"]),
                            mv, sad, _t(taps),
                            tuple(_t(b) for b in c["bounds"]), mv_pen=tp)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert not np.array_equal(got[0].numpy(), mv.numpy() * 8)


def test_near_mv_lattice_matches_jax_and_find_near():
    """6 x 7 random MV field with zeros and duplicates: the device lattice
    vs the JAX function and vs the host Encoder's _find_near under the
    all-inter assumption (the case of tests/test_tpu_encoder.py)."""
    rng = np.random.RandomState(11)
    R, C = 6, 7
    mvf = rng.randint(-3, 4, size=(R, C, 2)).astype(np.int32) * 8
    mvf[rng.rand(R, C) < 0.4] = 0
    got = TME.near_mv_lattice(_t(mvf.reshape(-1, 2)), R, C)
    want = JME.near_mv_lattice(jnp.asarray(mvf.reshape(-1, 2)), R, C)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)
    enc = Encoder(C * 16, R * 16, qindex=30)
    enc.mode = np.full((R + 1, C + 1), NEWMV, np.int32)
    enc.reff = np.zeros((R + 1, C + 1), np.int32)
    enc.reff[1:, 1:] = LAST_FRAME
    enc.mv = np.zeros((R + 1, C + 1, 2), np.int32)
    enc.mv[1:, 1:] = mvf
    nst, nr, best, cnt = (g.numpy() for g in got)
    for r in range(R):
        for c in range(C):
            near, nearest, bst, probs, _cnt = enc._find_near(r, c)
            n = r * C + c
            assert tuple(nst[n]) == nearest, (r, c)
            assert tuple(nr[n]) == near, (r, c)
            assert tuple(best[n]) == bst, (r, c)
            assert [int(TT.MODE_CONTEXTS[cnt[n, i], i])
                    for i in range(4)] == probs, (r, c)


@pytest.mark.parametrize("bw", [16, 8])
def test_intra_mode_preds_match_jax(bw):
    rng = np.random.default_rng(bw)
    R, C = 4, 6
    N = R * C
    b = B if bw == 16 else B // 2
    plane = rng.integers(0, 256, (R * bw + 2 * b, C * bw + 2 * b)) \
        .astype(np.uint8)
    src = rng.integers(0, 256, (N, bw, bw)).astype(np.int32)
    pos = np.stack([b + (np.arange(N) // C) * bw,
                    b + (np.arange(N) % C) * bw], 1).astype(np.int32)
    got = TME.intra_mode_preds(_t(plane), _t(pos), R, C, bw)
    assert got.dtype == torch.int32
    _eq(got, JME.intra_mode_preds(jnp.asarray(plane), jnp.asarray(pos), R, C,
                                  bw))
    _eq(TME.intra_mode_costs(_t(plane), _t(src), _t(pos), R, C, bw),
        JME.intra_mode_costs(jnp.asarray(plane), jnp.asarray(src),
                             jnp.asarray(pos), R, C, bw))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("geom, rng, odd_wx", [
    ((6, 8), 16, False), ((3, 3), 16, False), ((1, 5), 16, False),
    ((5, 1), 16, False), ((6, 8), 7, False), ((6, 8), 1, False),
    ((3, 3), 16, True)])
def test_sad_grid_kernel_matches_plain_on_card(cuda_device, geom, rng,
                                               odd_wx):
    c = _search_case(*geom, 3)
    c["wy"] = c["mb_pos"][:, 0] + c["centers"][:, 0] - rng
    wx = c["mb_pos"][:, 1] + c["centers"][:, 1] - rng
    if odd_wx:
        wx = np.where(wx % 2, wx, np.where(wx > 0, wx - 1, wx + 1))
    c["wx"] = wx.astype(np.int32)
    args = [_t(c[k]).to(cuda_device) for k in ("plane", "wy", "wx", "src")]
    before = _cuda.launches["sad_grid"]
    got = me_sad.sad_grid(*args, rng)
    torch.cuda.synchronize()
    assert _cuda.launches["sad_grid"] == before + 1
    assert tuple(got.shape) == (geom[0] * geom[1], 2 * rng + 1, 2 * rng + 1)
    assert torch.equal(got, me_sad.sad_grid_plain(*args, rng))
    assert torch.equal(got.cpu(), me_sad.sad_grid_plain(
        *(_t(c[k]) for k in ("plane", "wy", "wx", "src")), rng))
