"""MB-row-sharded VP8 encode: port of
libvpx_opencl_tpu/parallel/sharded_encode.py (ShardedTPUEncoder).

TorchEncoder's four device hooks run per row shard of a ('row',) mesh
(parallel/mesh.py; rows split as parallel/sharded_wavefront.split_rows
splits them), each shard on its device; the decision and encode hooks
give each shard its `FrameInputs.rows` view of the frame's inputs:

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

    def _gather(self, outs):
        """Per-shard tuples of per-MB results -> one tuple on the first
        device, in MB order."""
        return tuple(torch.cat([o[k].to(self.device) for o in outs])
                     for k in range(len(outs[0])))

    # -- the hooks ----------------------------------------------------------

    def _decide_key_fn(self, fi):
        return self._gather([TE._decide_rd_key(fi.rows(r0, r1, d), r0)
                             for (r0, r1), d in zip(self.rows, self._devs)])

    def _decide_inter_fn(self, fi):
        if fi.sf.bpred:
            raise ValueError("ShardedTorchEncoder runs with sf.bpred off")
        views = [fi.rows(r0, r1, d) for (r0, r1), d in zip(self.rows,
                                                           self._devs)]
        mvs = [TE._search_refs(v) for v in views]
        outs = []
        for s, (r0, r1) in enumerate(self.rows):
            # the lattice's one cross-row input: the LAST search's MV row
            # above this shard
            above = None if s == 0 else \
                mvs[s - 1][0][-self.C:].to(self._devs[s])
            lattice = ME.near_mv_lattice(mvs[s][0], r1 - r0, self.C, above,
                                         r0, self.R)
            outs.append(TE._rd_inter(views[s], mvs[s], lattice, r0))
        return self._gather(outs)

    def _encode_fn(self, fi, has_bpred):
        if has_bpred:
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
                fi.rows(r0, r1, self._devs[s]), False, top)
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
            [lf_params[r0 * C:r1 * C].to(d)
             for (r0, r1), d in zip(self.rows, self._devs)]
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
