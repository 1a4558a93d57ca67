"""Decode closed loop over `TorchDecoder.decode_frame_core`, as
`vpxdec --noblit` decodes: no readback, the decoder's own pipeline on (the
host entropy thread feeds the dispatch worker on its CUDA stream). The
stream is decoded over and over by one decoder; it opens on a keyframe,
so every pass starts clean.

Each shown frame's handle is held until the pass ends (`due`); then the
harness stops its clock and `drain` reads the pass's frames back and
hands them to the reference's digest (`reference/<config["check"]>.py`),
so that the card holds at most one pass of frames and the check still
covers every frame the window produced.
"""
from vp8bench.harness import loader


class Driver:
    def __init__(self, config, traffic, inputs, device):
        import torch
        from libvpx_opencl_tpu_torch.models.torch_decoder import TorchDecoder
        self._sync_card = torch.cuda.synchronize if device == "cuda" \
            else (lambda: None)
        self._digest = loader.module("reference", config["check"]).digest
        self.dec = TorchDecoder(device=device)
        self.payloads = inputs["payloads"]
        self.i = 0
        self.held = []          # (stream index, frame handle), this pass
        self.digests = []       # (stream index, digest or None)

    def warm(self):
        """One pass of the stream: every shape the window decodes."""
        for payload in self.payloads:
            self.dec.decode_frame_core(payload)
        self.finish()

    def step(self):
        k = self.i % len(self.payloads)
        self.i += 1
        if self.dec.decode_frame_core(self.payloads[k]):
            self.held.append((k, self.dec.frame_to_show))

    def finish(self):
        self.dec._sync()
        self._sync_card()

    def due(self):
        return len(self.held) >= len(self.payloads)

    def drain(self):
        """The held frames' visible planes, read back after finish(), to
        the digest; a frame that cannot be read digests as None."""
        held, self.held = self.held, []
        for k, fr in held:
            try:
                planes = fr.visible()
            except Exception:       # judged as a frame that never came
                planes = None
            self.digests.append((k, None if planes is None
                                 else self._digest(*planes)))

    def outputs(self):
        """{"frames"}: (stream index, digest or None) of every shown
        frame."""
        self.drain()
        digests, self.digests = self.digests, []
        return {"frames": digests}

    def close(self):
        self.dec = None
