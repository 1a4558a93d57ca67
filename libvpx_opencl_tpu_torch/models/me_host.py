"""Host-side whole-frame full-pel motion match (shared by pass-1 analysis
and the ARNR temporal filter).

The reference's first pass and temporal filter both run a per-MB motion
search (vp8_first_pass firstpass.c:481 via vp8_diamond_search_sad;
find_matching_mb temporal_filter.c:139).  TPU-first restructuring: MBs are
axis-aligned and disjoint, so the SAD of *every* MB at one global offset
(dy, dx) is a whole-plane |shifted_ref - cur| followed by a non-overlapping
16x16 block sum — no per-MB loops, no window gathers.  A step-2 offset grid
plus a +-1 refine bounds the work at ~(K/2)^2 + 8 whole-plane passes
(the reference's own pass-1 search is a diamond, also non-exhaustive).
"""
from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def fullpel_match(cur16, ref16, mc_range, step=2):
    """Match every aligned 16x16 MB of cur16 against ref16 within
    +-mc_range full-pel.  Both planes must have multiple-of-16 dims.

    Returns (dy, dx, sse, zsse): per-MB [R, C] best offsets, the SSE of
    the matched prediction, and the zero-MV SSE."""
    H, W = cur16.shape
    R, C = H // 16, W // 16
    K = 2 * mc_range + 1
    cur = cur16.astype(np.int16)
    pi = np.pad(ref16, mc_range, mode="edge")

    def sad_at(i, j):
        d = np.abs(pi[i:i + H, j:j + W].astype(np.int16) - cur)
        return d.reshape(R, 16, C, 16).sum((1, 3), dtype=np.int32)

    # pass 1: step-2 grid (always includes the zero offset)
    grid = list(range(-mc_range, mc_range + 1, step))
    if 0 not in grid:
        grid.append(0)
        grid.sort()
    best = None
    bi = bj = None
    for dy in grid:
        for dx in grid:
            sad = sad_at(dy + mc_range, dx + mc_range)
            if best is None:
                best = sad
                bi = np.full((R, C), dy + mc_range, np.int32)
                bj = np.full((R, C), dx + mc_range, np.int32)
            else:
                better = sad < best
                best = np.where(better, sad, best)
                bi = np.where(better, dy + mc_range, bi)
                bj = np.where(better, dx + mc_range, bj)

    # pass 2: +-1 refine around each MB's winner (per-MB offsets now
    # differ, so gather 16x16 windows instead of slicing planes)
    wins = sliding_window_view(pi, (16, 16))
    rr = np.arange(R)[:, None] * 16
    cc = np.arange(C)[None, :] * 16
    base = cur.reshape(R, 16, C, 16).transpose(0, 2, 1, 3)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            ci = np.clip(bi + di, 0, K - 1)
            cj = np.clip(bj + dj, 0, K - 1)
            cand = wins[rr + ci, cc + cj].astype(np.int16)
            sad = np.abs(cand - base).sum((2, 3), dtype=np.int32)
            better = sad < best
            best = np.where(better, sad, best)
            bi = np.where(better, ci, bi)
            bj = np.where(better, cj, bj)

    pred = wins[rr + bi, cc + bj].astype(np.int32)
    base32 = base.astype(np.int32)
    sse = ((base32 - pred) ** 2).sum((2, 3))
    zpred = wins[rr + mc_range, cc + mc_range].astype(np.int32)
    zsse = ((base32 - zpred) ** 2).sum((2, 3))
    return bi - mc_range, bj - mc_range, sse, zsse
