"""GOP data parallelism: port of libvpx_opencl_tpu/parallel/gop.py.

`StreamSetDecoder` decodes G streams in lockstep, one 'gop' group of a
('gop', 'row') mesh (parallel/mesh.py) each, from one process: a group of
one shard runs a TorchDecoder on its card, a group of several a
ShardedTorchDecoder over its row shards. Each group has one long-lived
host thread that decodes its stream's frame and reads it back, under the
group's card, so that a group's entropy decode and device work proceed
independently of the others' (the reference runs one vpxdec process per
stream); `decode` returns once every stream's frame is on the host. With
tracing on, the set is one frame of the trace: a root `gop.set` in the
caller, handed to each group's `gop.stream` (attributes `card`, `stream`,
a count `frames.<device>`), under which the stream's `dec.decode` takes
the set's frame id; `gop.set_wait` spans the first stream's return to the
last one's. `decode_streams` decodes whole streams through it.

`encode_gops` cuts a clip into keyframe-led groups of gop_len frames and
encodes the groups concurrently, one TorchEncoder and one host thread
each, group i on shard i % n of a one-axis mesh. A keyframe resets every
piece of encoder state the bitstream depends on (the reference ring, and
the adaptive probabilities through Encoder._reset_key_frame_state), so
the concatenated payloads equal a sequential encode with the same
keyframes byte for byte (tests/test_torch_gop.py).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models.torch_decoder import TorchDecoder, use_card
from ..utils import trace
from .mesh import make_mesh, make_row_mesh, submeshes
from .sharded_decode import ShardedTorchDecoder


class StreamSetError(RuntimeError):
    """Some streams' frames of one set raised. `errors` maps each failed
    stream's index to its exception; `frames` is the set as `decode`
    would have returned it, None for the failed streams. The other
    streams' decoders took their frames."""

    def __init__(self, errors, frames):
        super().__init__("streams " + ", ".join(
            f"{k} ({e!r})" for k, e in sorted(errors.items())) + " failed")
        self.errors, self.frames = errors, frames


class StreamSetDecoder:
    """Decode n_streams VP8 streams frame by frame in lockstep over a
    ('gop', 'row') mesh of n_devices shards (default: one per stream),
    n_streams groups of n_devices // n_streams row shards each; shard i
    on card i % torch.cuda.device_count() (parallel/mesh.py)."""

    def __init__(self, n_streams, n_devices=None, device="cuda"):
        self.mesh = make_mesh(n_streams if n_devices is None else n_devices,
                              gop=n_streams, device=device)
        groups = submeshes(self.mesh)
        #: each group's first shard device (its card for a TorchDecoder)
        self.devices = [g.devices[0] for g in groups]
        self._decoders = [TorchDecoder(device=g.devices[0])
                          if g.shape["row"] == 1 else
                          ShardedTorchDecoder(mesh=g) for g in groups]
        self._threads = [ThreadPoolExecutor(max_workers=1,
                                            initializer=use_card,
                                            initargs=(d,))
                         for d in self.devices]

    def decode(self, payloads):
        """Decode one frame of every stream: payloads[k] is stream k's
        compressed frame, or None to leave stream k alone this time.
        Returns per stream the shown frame's visible (y, u, v) uint8 host
        planes, or None (no payload, or a frame not shown), once every
        stream has its frame. Raises StreamSetError after the set if any
        stream's frame raised."""
        if len(payloads) != len(self._decoders):
            raise ValueError(f"{len(payloads)} payloads for "
                             f"{len(self._decoders)} streams")
        with trace.span("gop.set", new_frame=True):
            origin = trace.handoff()
            futs = {k: self._threads[k].submit(self._decode_one, k, p,
                                               origin)
                    for k, p in enumerate(payloads) if p is not None}
            frames = [None] * len(payloads)
            errors, ends = {}, []
            for k, fut in futs.items():
                frames[k], err, t_end = fut.result()
                ends.append(t_end)
                if err is not None:
                    errors[k] = err
            if ends:
                trace.interval("gop.set_wait", min(ends), max(ends))
        if errors:
            raise StreamSetError(errors, frames)
        return frames

    def _decode_one(self, k, payload, origin):
        """Stream k's frame on its group thread: (visible host planes or
        None, the exception it raised or None, perf_counter_ns at the
        end). A failed frame is returned, not raised, so that it fails
        its stream alone."""
        frame, parent = trace.picked_up("gop.queue_wait", origin)
        dec = self._decoders[k]
        planes = err = None
        try:
            with trace.span("gop.stream", frame=frame, parent=parent) as sp:
                if sp:
                    dev = self.devices[k]
                    sp.attrs.update({"card": -1 if dev.index is None
                                     else dev.index, "stream": k,
                                     f"frames.{dev}": 1})
                if dec.decode_frame_core(payload):
                    planes = dec.frame_to_show.visible()
        except Exception as e:      # the stream's failure, for the caller
            err = e
        return planes, err, time.perf_counter_ns()

    def synchronize(self):
        """Wait for every group's dispatch worker and every card the mesh
        uses."""
        for dec in self._decoders:
            dec._sync()
        for d in {d for d in self.mesh.devices.reshape(-1)
                  if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    def close(self):
        """End the group threads and the decoders' dispatch workers."""
        for pool in self._threads:
            pool.shutdown(wait=True)
        for dec in self._decoders:
            dec.close()
        self._threads, self._decoders = [], []


def decode_streams(streams, n_devices=None, gop=None, device="cuda"):
    """Decode G streams concurrently, one gop group each, through a
    StreamSetDecoder.

    streams: list of frame-payload lists. Returns a list (per stream) of
    lists of (y, u, v) shown frames. len(streams) must equal the mesh's
    gop extent."""
    mesh = make_mesh(n_devices, gop=gop if gop is not None
                     else max(1, len(streams)), device=device)
    if len(streams) != mesh.shape["gop"]:
        raise ValueError(f"{len(streams)} streams != gop={mesh.shape['gop']}")
    dec = StreamSetDecoder(len(streams), mesh.devices.size, device)
    out = [[] for _ in streams]
    try:
        for t in range(max(map(len, streams), default=0)):
            frames = dec.decode([s[t] if t < len(s) else None
                                 for s in streams])
            for k, planes in enumerate(frames):
                if planes is not None:
                    out[k].append(tuple(np.asarray(p).copy()
                                        for p in planes))
    finally:
        dec.close()
    return out


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
