"""Host entropy thread, ms per frame: `TorchDecoder.decode_frame_core`
(headers and modes in `refdec`, the native detokenize, `_prep_arrays`, the
hand-off to the dispatch worker), timed around each call in the window."""
TD = "libvpx_opencl_tpu_torch.models.torch_decoder"
SPANS = [
    {"target": TD + ":TorchDecoder.decode_frame_core",
     "name": "dec.entropy"},
]


def read(ctx):
    return ctx.ms_per_frame("dec.entropy")
