"""Encoder host pack, ms per frame: `TorchEncoder._pack` (modes, MVs and
tokens into the bool encoder, native and Python), bracketed by
torch.cuda.synchronize(), so the loop filter enqueued before it is not in
it."""
TE = "libvpx_opencl_tpu_torch.models.torch_encoder"
SPANS = [
    {"target": TE + ":TorchEncoder._pack",
     "name": "enc.host_pack", "sync": True},
]


def read(ctx):
    return ctx.ms_per_frame("enc.host_pack")
