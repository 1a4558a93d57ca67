"""Dispatch worker, ms per frame: `TorchDecoder._worker_dispatch` (uploads,
enqueue of the device work, the reference-ring swap) on its own thread,
timed around each call in the window."""
TD = "libvpx_opencl_tpu_torch.models.torch_decoder"
SPANS = [
    {"target": TD + ":TorchDecoder._worker_dispatch",
     "name": "dec.dispatch"},
]


def read(ctx):
    return ctx.ms_per_frame("dec.dispatch")
