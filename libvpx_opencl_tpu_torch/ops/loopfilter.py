"""Vectorized VP8 loop-filter math (PyTorch).

Port of libvpx_opencl_tpu/ops/loopfilter.py: bit-exact tensor forms of the
scalar filters in vp8/common/loopfilter_filters.c. Each function takes the
pixel vectors p3..q3 across one edge (int32 tensors holding uint8 values,
any broadcastable shape) and returns the filtered pixels. The edge order,
which makes the loop filter a wavefront, lives in ops/wavefront.py.
"""
import torch


def _sclamp(t):
    return t.clamp(-128, 127)


def filter_mask(limit, blimit, p3, p2, p1, p0, q0, q1, q2, q3):
    """vp8_filter_mask (loopfilter_filters.c:27-41): True = apply."""
    steps = torch.stack([p3 - p2, p2 - p1, p1 - p0, q1 - q0, q2 - q1,
                         q3 - q2]).abs().amax(0)
    return (steps <= limit) & \
        ((p0 - q0).abs() * 2 + (p1 - q1).abs() // 2 <= blimit)


def hev_mask(thresh, p1, p0, q0, q1):
    """vp8_hevmask (loopfilter_filters.c:43-49)."""
    return ((p1 - p0).abs() > thresh) | ((q1 - q0).abs() > thresh)


def filter4(mask, hev, p1, p0, q0, q1):
    """vp8_filter (loopfilter_filters.c:51-98). Returns (p1, p0, q0, q1)."""
    ps1, ps0, qs0, qs1 = p1 - 128, p0 - 128, q0 - 128, q1 - 128
    zero = torch.zeros_like(ps1)
    f = _sclamp(ps1 - qs1)
    f = torch.where(hev, f, zero)
    f = _sclamp(f + 3 * (qs0 - ps0))
    f = torch.where(mask, f, zero)
    f1 = _sclamp(f + 4) >> 3
    f2 = _sclamp(f + 3) >> 3
    oq0 = _sclamp(qs0 - f1) + 128
    op0 = _sclamp(ps0 + f2) + 128
    f = (f1 + 1) >> 1
    f = torch.where(hev, zero, f)
    oq1 = _sclamp(qs1 - f) + 128
    op1 = _sclamp(ps1 + f) + 128
    return op1, op0, oq0, oq1


def mbfilter(mask, hev, p2, p1, p0, q0, q1, q2):
    """vp8_mbfilter (loopfilter_filters.c:161-227).
    Returns (p2, p1, p0, q0, q1, q2)."""
    ps2, ps1, ps0 = p2 - 128, p1 - 128, p0 - 128
    qs0, qs1, qs2 = q0 - 128, q1 - 128, q2 - 128
    zero = torch.zeros_like(ps1)
    f = _sclamp(ps1 - qs1)
    f = _sclamp(f + 3 * (qs0 - ps0))
    f = torch.where(mask, f, zero)
    f2 = torch.where(hev, f, zero)
    f1 = _sclamp(f2 + 4) >> 3
    f2 = _sclamp(f2 + 3) >> 3
    qs0 = _sclamp(qs0 - f1)
    ps0 = _sclamp(ps0 + f2)
    fw = torch.where(hev, zero, f)
    u = _sclamp((63 + fw * 27) >> 7)
    oq0 = _sclamp(qs0 - u) + 128
    op0 = _sclamp(ps0 + u) + 128
    u = _sclamp((63 + fw * 18) >> 7)
    oq1 = _sclamp(qs1 - u) + 128
    op1 = _sclamp(ps1 + u) + 128
    u = _sclamp((63 + fw * 9) >> 7)
    oq2 = _sclamp(qs2 - u) + 128
    op2 = _sclamp(ps2 + u) + 128
    return op2, op1, op0, oq0, oq1, oq2


def simple_filter(mask, p1, p0, q0, q1):
    """vp8_simple_filter (loopfilter_filters.c:292-330). Returns (p0, q0)."""
    ps1, ps0, qs0, qs1 = p1 - 128, p0 - 128, q0 - 128, q1 - 128
    f = _sclamp(ps1 - qs1)
    f = _sclamp(f + 3 * (qs0 - ps0))
    f = torch.where(mask, f, torch.zeros_like(f))
    f1 = _sclamp(f + 4) >> 3
    f2 = _sclamp(f + 3) >> 3
    oq0 = _sclamp(qs0 - f1) + 128
    op0 = _sclamp(ps0 + f2) + 128
    return op0, oq0


def filter_edge(pix8, blimit, limit, thresh, mb_edge, apply):
    """Normal filter across one edge: pix8 [..., 8] = p3..q3 along the last
    axis; blimit/limit/thresh/apply broadcast against pix8[..., 0].
    Returns the filtered [..., 8] (p3/q3 unchanged; p2/q2 only on MB
    edges)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = pix8.unbind(-1)
    mask = filter_mask(limit, blimit, p3, p2, p1, p0, q0, q1, q2, q3) & apply
    hev = hev_mask(thresh, p1, p0, q0, q1)
    if mb_edge:
        p2, p1, p0, q0, q1, q2 = mbfilter(mask, hev, p2, p1, p0, q0, q1, q2)
    else:
        p1, p0, q0, q1 = filter4(mask, hev, p1, p0, q0, q1)
    return torch.stack([p3, p2, p1, p0, q0, q1, q2, q3], -1)


def simple_filter_edge(pix8, blimit, apply):
    """Simple filter across one edge (luma only): blimit test, then p0/q0."""
    p3, p2, p1, p0, q0, q1, q2, q3 = pix8.unbind(-1)
    mask = ((p0 - q0).abs() * 2 + (p1 - q1).abs() // 2 <= blimit) & apply
    p0, q0 = simple_filter(mask, p1, p0, q0, q1)
    return torch.stack([p3, p2, p1, p0, q0, q1, q2, q3], -1)
