"""Host detokenize, ms per frame: `TorchDecoder._detokenize_all` (the
native C++ token decode), timed around each call in the window."""
TD = "libvpx_opencl_tpu_torch.models.torch_decoder"
SPANS = [
    {"target": TD + ":TorchDecoder._detokenize_all",
     "name": "dec.detokenize"},
]


def read(ctx):
    return ctx.ms_per_frame("dec.detokenize")
