"""Decode closed loop over a set of streams, one per card, from one
process: the port's stream-set decoder (`parallel/gop.py:StreamSetDecoder`)
over a ('gop', 'row') mesh of `config["mesh"]`, every frame read to the
host. Stream k is the configuration's stream started `offsets[k]` frames
in (the traffic's, modulo the stream's length); set t decodes frame
(t + offsets[k]) mod length of every stream k, and a step returns when
all of them are on the host. One step is one set: the window's frames
are sets, each stream's own frame rate.

The set decoder is built on `device`: "cuda" puts group i on card i and
refuses fewer cards than streams; "cpu" makes every group a CPU shard
(the tests). Each pass's host planes are held until every stream has
made a pass (`due`); then the harness stops its clock and `drain` hands
them to the reference's digest as (frame index, digest), so that
`md5_frames` checks every frame of every stream against the one golden
list.
"""
import sys

from vp8bench.harness import loader


class Driver:
    def __init__(self, config, traffic, inputs, device):
        import torch
        from libvpx_opencl_tpu_torch.parallel import mesh
        from libvpx_opencl_tpu_torch.parallel.gop import StreamSetDecoder
        n = config["streams"]
        shape = config["mesh"]
        if len(traffic["offsets"]) != n or shape["gop"] != n:
            raise ValueError(f"{n} streams, {len(traffic['offsets'])} "
                             f"offsets, a mesh of {shape['gop']} groups")
        if device == "cuda" and torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} streams need {n} cards, one each; "
                               f"{torch.cuda.device_count()} present")
        self._digest = loader.module("reference", config["check"]).digest
        self.dec = StreamSetDecoder(n, n * shape["row"], device)
        print("mesh: " + mesh.shard_map_line(self.dec.mesh), file=sys.stderr,
              flush=True)
        self.payloads = inputs["payloads"]
        self.offsets = [o % len(self.payloads) for o in traffic["offsets"]]
        self.t = 0
        self.held = []          # (frame index, host planes), this pass
        self.digests = []       # (frame index, digest or None)

    def warm(self):
        """Each stream through one whole pass and then its offset, so that
        set 0 of the window decodes frame offsets[k] of stream k: every
        shape of the window, the readback included."""
        n = len(self.payloads)
        for i in range(n + max(self.offsets)):
            self.dec.decode([self.payloads[i % n] if i < n + o else None
                             for o in self.offsets])
        self.finish()

    def step(self):
        n = len(self.payloads)
        idx = [(self.t + o) % n for o in self.offsets]
        self.t += 1
        frames = [None] * len(idx)
        try:
            frames = self.dec.decode([self.payloads[i] for i in idx])
        except Exception as e:
            # the other streams' frames of a set in which some failed
            frames = getattr(e, "frames", frames)
            raise
        finally:
            # a stream's frame that never came digests as None
            self.held.extend(zip(idx, frames))

    def finish(self):
        self.dec.synchronize()

    def due(self):
        return len(self.held) >= len(self.payloads) * len(self.offsets)

    def drain(self):
        held, self.held = self.held, []
        self.digests.extend((i, None if planes is None
                             else self._digest(*planes))
                            for i, planes in held)

    def outputs(self):
        """{"frames"}: (frame index, digest or None) of every frame of
        every stream."""
        self.drain()
        digests, self.digests = self.digests, []
        return {"frames": digests}

    def close(self):
        self.dec.close()
        self.dec = None
