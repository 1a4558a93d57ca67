"""GOP data parallelism: port of libvpx_opencl_tpu/parallel/gop.py.

`decode_streams` gives each of G streams one 'gop' group of a
('gop', 'row') mesh (parallel/mesh.py) and decodes it with a
ShardedTorchDecoder over the group's row shards, one host thread per
group: a group's entropy decode and device work proceed independently of
the others' (the reference runs one vpxdec process per stream).

`encode_gops` cuts a clip into keyframe-led groups of gop_len frames and
encodes the groups concurrently, one TorchEncoder and one host thread
each, group i on shard i % n of a one-axis mesh. A keyframe resets every
piece of encoder state the bitstream depends on (the reference ring, and
the adaptive probabilities through Encoder._reset_key_frame_state), so
the concatenated payloads equal a sequential encode with the same
keyframes byte for byte (tests/test_torch_gop.py).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .mesh import make_mesh, make_row_mesh, submeshes
from .sharded_decode import ShardedTorchDecoder


def decode_streams(streams, n_devices=None, gop=None, device="cuda"):
    """Decode G streams concurrently, one gop group each.

    streams: list of frame-payload lists. Returns a list (per stream) of
    lists of (y, u, v) shown frames. len(streams) must equal the mesh's
    gop extent."""
    mesh = make_mesh(n_devices, gop=gop if gop is not None
                     else max(1, len(streams)), device=device)
    groups = submeshes(mesh)
    if len(streams) != len(groups):
        raise ValueError(f"{len(streams)} streams != gop={len(groups)}")

    def run(args):
        payloads, rows_mesh = args
        dec = ShardedTorchDecoder(mesh=rows_mesh)
        out = []
        for payload in payloads:
            show, planes = dec.decode_frame(payload)
            if show:
                out.append(tuple(np.asarray(p).copy() for p in planes))
        return out

    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        return list(pool.map(run, zip(streams, groups)))


def encode_gops(frames, w, h, gop_len, n_devices=None, qindex=24,
                device="cuda", sf=None, **enc_kwargs):
    """GOP-parallel encode of `frames` ((y, u, v) uint8 planes) in groups
    of gop_len frames, each led by a keyframe; enc_kwargs go to every
    TorchEncoder, and `sf` (SpeedFeatures), if given, is set on each after
    construction. Returns the flat payload list in display order."""
    from ..models.torch_encoder import TorchEncoder

    groups = [frames[i:i + gop_len] for i in range(0, len(frames),
                                                   gop_len)]
    devs = list(make_row_mesh(n_devices, device=device).devices)

    def run(args):
        gi, grp = args
        enc = TorchEncoder(w, h, qindex=qindex, device=devs[gi % len(devs)],
                           **enc_kwargs)
        if sf is not None:
            enc.sf = sf
        return [enc.encode_frame(y, u, v, keyframe=(i == 0))
                for i, (y, u, v) in enumerate(grp)]

    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        outs = list(pool.map(run, enumerate(groups)))
    return [p for grp in outs for p in grp]
