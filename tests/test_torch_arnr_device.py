"""ARNR follows the encoder's device (models/arnr.py): the altref
encoders hand synthesize_altref the TorchEncoder's device, and the host
Encoder keeps the NumPy path, as in the reference. On CPU tensors the
torch path's payloads equal those of a run whose ARNR is the NumPy
path (the card's are held equal to the host's by chip_smoke.py)."""
import pytest
import torch

from conftest import vector  # noqa: F401  (sys.path + CPU JAX)
from libvpx_opencl_tpu_torch.models import arnr
from libvpx_opencl_tpu_torch.models.encoder import Encoder
from libvpx_opencl_tpu_torch.models.torch_encoder import TorchEncoder
from test_encoder import synth

torch.set_num_threads(1)


def _altref_run(monkeypatch, make_enc, force_numpy=False):
    seen = []
    real = arnr.synthesize_altref

    def spy(*a, device=False, **kw):
        seen.append(device)
        return real(*a, device=False if force_numpy else device, **kw)

    monkeypatch.setattr(arnr, "synthesize_altref", spy)
    payloads = arnr.encode_sequence_altref(make_enc(), None,
                                           synth(176, 144, 6),
                                           gf_interval=4, max_frames=3)
    monkeypatch.setattr(arnr, "synthesize_altref", real)
    return payloads, seen


def test_altref_encode_hands_on_the_encoders_device(monkeypatch):
    def torch_enc():
        return TorchEncoder(176, 144, qindex=40, cpu_used=7, device="cpu")

    got, seen = _altref_run(monkeypatch, torch_enc)
    assert seen == [torch.device("cpu")]
    want, _ = _altref_run(monkeypatch, torch_enc, force_numpy=True)
    assert got == want
    # an invisible ARF was encoded between the shown frames
    assert len(got) == 7 and not got[4][0] & 0x10


def test_host_encoder_keeps_the_numpy_path(monkeypatch):
    _, seen = _altref_run(
        monkeypatch, lambda: Encoder(176, 144, qindex=40, cpu_used=7))
    assert seen == [False]


class _Stop(Exception):
    pass


def test_stream_and_twopass_altref_ask_for_the_device(monkeypatch):
    """The other two altref encoders hand on the device too (the spy stops
    each run at its first altref)."""
    seen = []

    def spy(*a, device=False, **kw):
        seen.append(device)
        raise _Stop

    class TwoPass:          # the TwoPassController fields read up to ARNR
        auto_altref = True
        arf_center_of = {0: 3}

        def want_keyframe(self):
            return False

    monkeypatch.setattr(arnr, "synthesize_altref", spy)
    enc = TorchEncoder(176, 144, qindex=40, cpu_used=7, device="cpu")
    frames = synth(176, 144, 6)
    with pytest.raises(_Stop):
        arnr.encode_stream_altref(enc, None, iter(frames), lag=6,
                                  gf_interval=2, max_frames=3)
    with pytest.raises(_Stop):
        arnr.encode_twopass_altref(enc, TwoPass(), frames, max_frames=3)
    assert seen == [torch.device("cpu")] * 2
