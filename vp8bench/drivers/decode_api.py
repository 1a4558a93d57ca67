"""Decode closed loop through the user API: `CodecDecoder.decode(frame)`
then `get_frame()` for every frame, postproc off, as a player or a
transcoder reads every frame's planes to the host. `get_frame` joins the
dispatch worker and copies the frame back, so the overlap of the
entropy thread with the device work is bypassed. The stream is decoded
over and over by one decoder; it opens on a keyframe.

Each pass's host planes are held until the pass ends (`due`); then the
harness stops its clock and `drain` hands them to the reference's digest
(`reference/<config["check"]>.py`).
"""
from vp8bench.harness import loader


class Driver:
    def __init__(self, config, traffic, inputs, device):
        import torch
        from libvpx_opencl_tpu_torch.api import CodecDecoder
        self._sync_card = torch.cuda.synchronize if device == "cuda" \
            else (lambda: None)
        self._digest = loader.module("reference", config["check"]).digest
        self.dec = CodecDecoder(device=device)
        self.payloads = inputs["payloads"]
        self.i = 0
        self.held = []          # (stream index, host planes), this pass
        self.digests = []       # (stream index, digest)

    def warm(self):
        for payload in self.payloads:
            self.dec.decode(payload)
            list(self.dec.get_frame())
        self.finish()

    def step(self):
        k = self.i % len(self.payloads)
        self.i += 1
        self.dec.decode(self.payloads[k])
        for planes in self.dec.get_frame():
            self.held.append((k, planes))

    def finish(self):
        self._sync_card()

    def due(self):
        return len(self.held) >= len(self.payloads)

    def drain(self):
        held, self.held = self.held, []
        self.digests.extend((k, self._digest(*planes)) for k, planes in held)

    def outputs(self):
        """{"frames"}: (stream index, digest) of every shown frame."""
        self.drain()
        digests, self.digests = self.digests, []
        return {"frames": digests}

    def close(self):
        self.dec = None
