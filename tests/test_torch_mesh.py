"""Meshes of the port's multi-GPU drivers (parallel/mesh.py): shapes and
axes as the JAX make_mesh / make_row_mesh / submeshes give them, the
shard-to-card map (shard i on card i % cards), and no fallback: the
default device is the card, and without one a mesh raises."""
import pytest
import torch

from libvpx_opencl_tpu_torch.parallel import mesh as M


def test_mesh_shapes_on_cpu():
    m = M.make_mesh(8, gop=2, device="cpu")
    assert m.axis_names == ("gop", "row")
    assert m.shape == {"gop": 2, "row": 4}
    assert M.make_mesh(6, device="cpu").shape == {"gop": 2, "row": 3}
    assert M.make_mesh(3, device="cpu").shape == {"gop": 1, "row": 3}
    assert M.make_mesh(device="cpu").shape == {"gop": 1, "row": 1}
    subs = M.submeshes(m)
    assert [s.shape for s in subs] == [{"row": 4}] * 2
    assert all(s.axis_names == ("row",) for s in subs)
    r = M.make_row_mesh(5, device="cpu")
    assert r.shape == {"row": 5}
    assert set(r.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError):
        M.submeshes(r)
    with pytest.raises(ValueError):
        M.make_row_mesh(0, device="cpu")


def test_shard_to_card_map(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = M.make_row_mesh(5)
    assert [str(d) for d in m.devices] == ["cuda:0", "cuda:1", "cuda:0",
                                          "cuda:1", "cuda:0"]
    assert M.make_row_mesh().shape == {"row": 2}
    assert M.shard_map_line(M.make_mesh(4, gop=2)) == (
        "shard 0 -> cuda:0, shard 1 -> cuda:1, shard 2 -> cuda:0, "
        "shard 3 -> cuda:1")
    with pytest.raises(ValueError, match="places its shards"):
        M.make_row_mesh(2, device="cuda:1")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        M.make_row_mesh()
    with pytest.raises(RuntimeError, match="CUDA card"):
        M.make_mesh(2, gop=1)
