"""Encode closed loop through the user API: `CodecEncoder.encode(frame)`
then `get_cx_data()` for every frame of the traffic's clip, looped. The
encoder is configured from the configuration file (constant quality,
`cq_level`, `kf_max_dist`, one token partition) at the port's default
speed features. Its first WARM_FRAMES frames are the set-up (a keyframe,
then inter frames with one and then two references: every shape the
window encodes); the window continues the same encoder, so its keyframes
fall every kf_max_dist frames, on the clip's first frame when the clip is
kf_max_dist long.

Every frame's payload and reconstruction (the encoder's `frame_to_show`,
kept on the card) is held for the check, the set-up's frames too: the
check follows the stream from its first keyframe.
"""

#: a keyframe, one inter frame with one reference, then inter frames with
#: two (the keyframe stays golden and altref: no golden interval)
WARM_FRAMES = 5
BORDER = 32          # VP8BORDERINPIXELS: the border of the encoder's planes


class Driver:
    def __init__(self, config, traffic, inputs, device):
        import torch
        from libvpx_opencl_tpu_torch.api import CodecEncoder, EncoderConfig
        self._sync_card = torch.cuda.synchronize if device == "cuda" \
            else (lambda: None)
        cfg = EncoderConfig(
            width=config["width"], height=config["height"],
            end_usage=config["end_usage"], cq_level=config["cq_level"],
            kf_max_dist=config["kf_max_dist"],
            token_partitions=config["token_partitions"])
        self.enc = CodecEncoder(cfg, device=device)
        self.w, self.h = config["width"], config["height"]
        self.clip = inputs["frames"]
        self.count = 0
        self.kept = []
        self.first = None

    def warm(self):
        for _ in range(WARM_FRAMES):
            self.step()
        self.finish()
        self.first = len(self.kept)

    def step(self):
        j = self.count % len(self.clip)
        self.count += 1
        self.enc.encode(self.clip[j])
        payload = b"".join(p["data"] for p in self.enc.get_cx_data()
                           if p["kind"] == "frame")
        self.kept.append((j, payload, self.enc._enc.frame_to_show))

    def finish(self):
        self._sync_card()

    def outputs(self):
        """{"width", "height", "source", "first", "frames"}: frames is a
        list of (clip index, payload, recon) in encode order, recon() the
        reconstruction's MB-aligned (y, u, v) host planes; first is the
        index of the window's first frame."""
        aw, ah = (self.w + 15) & ~15, (self.h + 15) & ~15
        b, b2 = BORDER, BORDER // 2

        def reader(fr):
            return lambda: (
                fr.y[b:b + ah, b:b + aw].cpu().numpy(),
                fr.u[b2:b2 + ah // 2, b2:b2 + aw // 2].cpu().numpy(),
                fr.v[b2:b2 + ah // 2, b2:b2 + aw // 2].cpu().numpy())
        frames = [(j, p, reader(fr)) for j, p, fr in self.kept]
        self.kept = []
        return {"width": self.w, "height": self.h, "source": self.clip,
                "first": self.first, "frames": frames}

    def close(self):
        self.enc = None
