"""MB-row-sharded VP8 encode: port of
libvpx_opencl_tpu/parallel/sharded_encode.py (ShardedTPUEncoder).

TorchEncoder's four device hooks run per row shard of a ('row',) mesh
(parallel/mesh.py; rows split as parallel/sharded_wavefront.split_rows
splits them), each shard on its device, with the global-view signatures
TorchEncoder calls them with:

  * decision (`_decide_key_fn`, `_decide_inter_fn`): each shard searches
    its MBs' motion against the replicated reference planes (the
    exhaustive step-1 grid through K3 at exhaustive_me) and makes the RD
    decision for its MBs; the near-MV lattice's one cross-row input, the
    LAST search's MV row above the shard, comes from the shard above (the
    JAX class's one-row ppermute);
  * encode (`_encode_fn`): MC, the trellis per MB, then the encode
    wavefront (models/wavefront.py) of each shard in shard order, shard
    s > 0 predicting its row 0 from shard s-1's last reconstructed pixel
    row (sharded_wavefront's unfiltered-row-first rule, `top`);
  * loop filter (`_lf_fn`): K2 across the shards
    (sharded_wavefront.filter_sharded), then the filtered shards are
    gathered into the bordered reference frame on the mesh's first device
    that the ring keeps (the JAX class's all-gather into a replicated
    ring); a hook copies what it reads to each shard's device.

Per-MB decisions depend only on the MB's own inputs and these halos, so
the payloads are byte-identical to TorchEncoder's under the same
SpeedFeatures (tests/test_torch_sharded_encode.py). As in the JAX class,
B_PRED is off (`sf.bpred` is forced False at construction): the B_PRED
candidate is costed over whole frames only, and the JAX package's sharded
lanes have no B_PRED recursion. Everything runs on the devices' current
streams, in shard order.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..models import torch_encoder as TE
from ..models.torch_decoder import B, B2, _extend_borders
from ..ops import me as ME
from ..ops import wavefront as W
from . import sharded_wavefront as SW
from .mesh import make_row_mesh


class ShardedTorchEncoder(TE.TorchEncoder):
    """TorchEncoder whose device hooks run MB-row-sharded over a ('row',)
    mesh (module docstring). Byte-identical payloads to TorchEncoder with
    the same SpeedFeatures, B_PRED off."""

    def __init__(self, *args, mesh=None, n_devices=None, device="cuda",
                 **kwargs):
        self.mesh = mesh if mesh is not None else \
            make_row_mesh(n_devices, device=device)
        self.n_row = self.mesh.shape["row"]
        self._devs = list(self.mesh.devices.reshape(-1))
        super().__init__(*args, device=self._devs[0], **kwargs)
        if self.sf.bpred:
            self.sf = replace(self.sf, bpred=False)
        self.rows = SW.split_rows(self.R, self.n_row)

    # -- per-shard views of the hooks' global-view arguments ---------------

    def _rep(self, s, *ts):
        """Replicated arguments on shard s's device (ints pass through)."""
        dev = self._devs[s]
        return [t.to(dev) if isinstance(t, torch.Tensor) else t for t in ts]

    def _part(self, s, *ts):
        """Shard s's MBs of per-MB arguments, on its device."""
        r0, r1 = self.rows[s]
        C = self.C
        return [t[r0 * C:r1 * C].to(self._devs[s]) for t in ts]

    def _gather(self, outs):
        """Per-shard tuples of per-MB results -> one tuple on the first
        device, in MB order."""
        return tuple(torch.cat([o[k].to(self.device) for o in outs])
                     for k in range(len(outs[0])))

    # -- the hooks ----------------------------------------------------------

    def _decide_key_fn(self, R, C, src_y_pl, src_u_pl, src_v_pl, yb, ub,
                       vb, tcb0, tcb1, tcb2, dq1, dq2, dqu, qidx, rdmult,
                       rddiv, ymode_cost, uvmode_cost):
        outs = []
        for s, (r0, r1) in enumerate(self.rows):
            outs.append(TE._decide_rd_key(
                r1 - r0, C, *self._rep(s, src_y_pl, src_u_pl, src_v_pl),
                *self._part(s, yb, ub, vb),
                *self._rep(s, tcb0, tcb1, tcb2),
                *self._part(s, dq1, dq2, dqu, qidx),
                *self._rep(s, rdmult, rddiv, ymode_cost, uvmode_cost),
                row_off=r0))
        return self._gather(outs)

    def _decide_inter_fn(self, R, C, n_refs, me_step, use_bpred,
                         refs_y, refs_u, refs_v,
                         src_y_pl, src_u_pl, src_v_pl, yb, ub, vb,
                         centers, taps, lo_r, hi_r, lo_c, hi_c,
                         mvcost, prev8, sadpb, tcb0, tcb1, tcb2, tcb3,
                         dq1, dq2, dqu, qidx, rdmult, rddiv,
                         ymode_cost, uvmode_cost, bmode_cost,
                         ci0, ci1, modectx, c0tab, c1tab):
        if use_bpred:
            raise ValueError("ShardedTorchEncoder runs with sf.bpred off")
        mvs = [TE._search_refs(
            r1 - r0, C, n_refs, me_step, *self._rep(s, refs_y),
            *self._part(s, yb, centers), *self._rep(s, taps),
            *self._part(s, lo_r, hi_r, lo_c, hi_c), *self._rep(s, mvcost),
            *self._part(s, prev8), sadpb, row_off=r0)
            for s, (r0, r1) in enumerate(self.rows)]
        outs = []
        for s, (r0, r1) in enumerate(self.rows):
            # the lattice's one cross-row input: the LAST search's MV row
            # above this shard
            above = None if s == 0 else \
                mvs[s - 1][0][-C:].to(self._devs[s])
            lattice = ME.near_mv_lattice(mvs[s][0], r1 - r0, C, above, r0, R)
            outs.append(TE._rd_inter(
                r1 - r0, C, n_refs, False, mvs[s], lattice,
                *self._rep(s, refs_y, refs_u, refs_v, src_y_pl, src_u_pl,
                           src_v_pl),
                *self._part(s, yb, ub, vb),
                *self._rep(s, taps, mvcost, tcb0, tcb1, tcb2, tcb3),
                *self._part(s, dq1, dq2, dqu, qidx),
                *self._rep(s, rdmult, rddiv, ymode_cost, uvmode_cost,
                           bmode_cost, ci0, ci1, modectx, c0tab, c1tab),
                row_off=r0))
        return self._gather(outs)

    def _encode_fn(self, R, C, use_trellis, refs_y, refs_u, refs_v, refk,
                   yb, ub, vb, mode, uv_mode, intra, mv8, taps, dq1, dq2,
                   dqu, qidx, tcb0, tcb1, tcb2, bmode_cost, rdmult, rddiv):
        if bmode_cost is not None:
            raise ValueError("ShardedTorchEncoder runs with sf.bpred off")
        outs, planes = [], []
        for s, (r0, r1) in enumerate(self.rows):
            top = None
            if s:
                rows = r0 - self.rows[s - 1][0]
                top = [pl[b + n * rows - 1].to(self._devs[s])
                       for pl, b, n in zip(planes[-1], (B, B2, B2),
                                           (16, 8, 8))]
            qcoeff, eobs, uvm, y, u, v, bmodes = TE._encode_device(
                r1 - r0, C, use_trellis,
                *self._rep(s, refs_y, refs_u, refs_v),
                *self._part(s, refk, yb, ub, vb, mode, uv_mode, intra, mv8),
                *self._rep(s, taps), *self._part(s, dq1, dq2, dqu, qidx),
                *self._rep(s, tcb0, tcb1, tcb2), None,
                *self._rep(s, rdmult, rddiv), row_off=r0, top=top)
            outs.append((qcoeff, eobs, uvm, bmodes))
            planes.append((y, u, v))
        qcoeff, eobs, uvm, bmodes = self._gather(outs)
        ys, us, vs = (list(p) for p in zip(*planes))
        return qcoeff, eobs, uvm, ys, us, vs, bmodes

    def _lf_fn(self, R, C, do_lf, ys, us, vs, lf_params):
        planes = list(zip(ys, us, vs))
        streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                   for d in self._devs[:len(planes)]]
        SW.filter_sharded(
            planes, streams,
            [self._part(s, lf_params)[0] for s in range(len(planes))]
            if do_lf else None, False)
        # gather into the whole bordered frame the ring keeps
        out = tuple(torch.empty(shape, dtype=torch.uint8, device=self.device)
                    for shape in W.plane_shapes(R, C))
        for (r0, r1), pls in zip(self.rows, planes):
            for full, pl, b, n in zip(out, pls, (B, B2, B2), (16, 8, 8)):
                full[b + r0 * n:b + r1 * n] = \
                    pl[b:b + (r1 - r0) * n].to(self.device)
        for full, b, n in zip(out, (B, B2, B2), (16, 8, 8)):
            _extend_borders(full, b, C * n, R * n)
        return out
