"""ShardedTorchEncoder vs the JAX ShardedTPUEncoder directly: payload
bytes equal (tolerance 0) at the multichip dryrun's size (64x64, 2
frames, cpu_used 7, qindex 40; __graft_entry__.dryrun_multichip) on 4 row
shards, the JAX class on 4 of the 8 virtual CPU devices. Frame 1 is also
encoded by a port encoder started from the JAX encoder's state after
frame 0 through load_encoder_state."""
import numpy as np
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu.parallel.sharded_decode import make_row_mesh as jmesh
from libvpx_opencl_tpu.parallel.sharded_encode import ShardedTPUEncoder
from libvpx_opencl_tpu_torch.models import torch_encoder as TE
from libvpx_opencl_tpu_torch.parallel.mesh import make_row_mesh
from libvpx_opencl_tpu_torch.parallel.sharded_encode import \
    ShardedTorchEncoder
from test_torch_encoder import _snapshot

torch.set_num_threads(1)


def _frames(w, h, n):
    """__graft_entry__.dryrun_multichip's frames."""
    rng = np.random.RandomState(3)
    base = rng.randint(0, 255, size=(h, w)).astype(np.uint8)
    out = []
    for t in range(n):
        out.append((np.roll(base, t, axis=1),
                    np.full((h // 2, w // 2), 100 + t, np.uint8),
                    np.full((h // 2, w // 2), 120, np.uint8)))
    return out


def test_sharded_encode_matches_jax_sharded_encoder():
    frames = _frames(64, 64, 2)
    jenc = ShardedTPUEncoder(64, 64, qindex=40, cpu_used=7, mesh=jmesh(4))
    want = [jenc.encode_frame(*frames[0], keyframe=True)]
    state = _snapshot(jenc)
    want.append(jenc.encode_frame(*frames[1]))

    def port():
        return ShardedTorchEncoder(64, 64, qindex=40, cpu_used=7,
                                   mesh=make_row_mesh(4, device="cpu"))

    enc = port()
    assert [enc.encode_frame(*frames[0], keyframe=True),
            enc.encode_frame(*frames[1])] == want
    mid = port()
    TE.load_encoder_state(mid, state)
    assert mid.encode_frame(*frames[1]) == want[1]
