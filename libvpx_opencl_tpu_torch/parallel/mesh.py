"""Device meshes for the multi-GPU drivers: the port of
libvpx_opencl_tpu/parallel/mesh.py, with `make_row_mesh` from
sharded_decode.py and `submeshes` from gop.py.

The axes mean what they mean in the JAX package:
  * 'gop'  — independent streams or GOPs, one group of shards each
    (parallel/gop.py);
  * 'row'  — the MB rows of one frame, split over the shards of a group
    (parallel/sharded_decode.py, sharded_encode.py).

One controller drives every shard: a single process holds a list of
`torch.device`s and orders the work of each shard on that device's CUDA
streams, as the JAX package's one process drives its mesh. A shard is a
place in the mesh, not a card: shard i of a mesh goes on card
`i % torch.cuda.device_count()`. On a machine with one card every shard
shares it (virtual shards: every halo copy runs, between buffers of one
card); with as many cards as shards each shard has its own and the halo
copies are peer copies. A mesh asked for on "cuda" without a card raises;
there is no fallback to the CPU. "cpu" puts every shard on the CPU (the
tests).
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """An array of `torch.device` with named axes (the jax.sharding.Mesh
    fields the drivers read): `devices` (numpy object array),
    `axis_names` and `shape` ({axis name: extent})."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def shard_devices(n, device="cuda"):
    """`n` shard devices of type `device` ("cuda" or "cpu"): shard i on
    card i % torch.cuda.device_count(). Raises if "cuda" has no card."""
    kind = torch.device(device)
    if kind.index is not None:
        raise ValueError(f"a mesh places its shards itself; pass "
                         f"'{kind.type}', not {device!r}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if kind.type == "cpu":
        return [torch.device("cpu")] * n
    if kind.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA card; pass "
                           "device='cpu' to run the shards on the CPU")
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def _default_count(device):
    kind = torch.device(device).type
    if kind == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def make_mesh(n_devices=None, gop=None, device="cuda"):
    """A ('gop', 'row') mesh of n_devices shards (default: one per card,
    one on the CPU): `gop` groups (default 2 when the count is even and
    above 1, else 1) of n_devices // gop row shards each."""
    n = _default_count(device) if n_devices is None else int(n_devices)
    if gop is None:
        gop = 2 if n % 2 == 0 and n > 1 else 1
    row = n // gop
    if row < 1:
        raise ValueError(f"{n} shards cannot form {gop} gop groups")
    devs = shard_devices(gop * row, device)
    arr = np.empty(gop * row, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(gop, row), ("gop", "row"))


def make_row_mesh(n_devices=None, device="cuda"):
    """A ('row',) mesh of n_devices shards (default: one per card, one on
    the CPU): one frame's MB rows across them."""
    n = _default_count(device) if n_devices is None else int(n_devices)
    arr = np.empty(n, dtype=object)
    arr[:] = shard_devices(n, device)
    return Mesh(arr, ("row",))


def submeshes(mesh):
    """Split a ('gop', 'row') mesh into per-group ('row',) meshes."""
    if mesh.axis_names != ("gop", "row"):
        raise ValueError(f"submeshes needs a ('gop', 'row') mesh, got "
                         f"{mesh.axis_names}")
    return [Mesh(row_devs, ("row",)) for row_devs in mesh.devices]


def shard_map_line(mesh):
    """'shard 0 -> cuda:0, shard 1 -> cuda:0, ...' for logs."""
    return ", ".join(f"shard {i} -> {d}"
                     for i, d in enumerate(mesh.devices.reshape(-1)))
