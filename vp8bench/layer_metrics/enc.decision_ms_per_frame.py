"""Encoder decision, ms per frame: `TorchEncoder._decide_key_fn` and
`_decide_inter_fn` (motion search with K3, RD choice, the B_PRED
candidate), each call bracketed by torch.cuda.synchronize() (traced runs
only: the syncs remove overlap)."""
TE = "libvpx_opencl_tpu_torch.models.torch_encoder"
SPANS = [
    {"target": TE + ":TorchEncoder._decide_key_fn",
     "name": "enc.decision", "sync": True},
    {"target": TE + ":TorchEncoder._decide_inter_fn",
     "name": "enc.decision", "sync": True},
]


def read(ctx):
    return ctx.ms_per_frame("enc.decision")
