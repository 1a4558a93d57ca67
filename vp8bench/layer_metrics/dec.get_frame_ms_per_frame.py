"""Decoder API readback, ms per frame: `CodecDecoder.get_frame` run to its
end (the join of the dispatch worker and the frame's device-to-host
copy), timed around each call in the window."""
API = "libvpx_opencl_tpu_torch.api"
SPANS = [
    {"target": API + ":CodecDecoder.get_frame",
     "name": "dec.get_frame", "consume": True},
]


def read(ctx):
    return ctx.ms_per_frame("dec.get_frame")
