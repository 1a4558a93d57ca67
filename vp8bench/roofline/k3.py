"""K3, the SAD grid of the exhaustive motion search (`csrc/sad_grid.cu`):
one launch per reference searched, through `ops/me_sad.py:_launch`.

Least work: bytes, the bordered reference plane, each MB's 16x16 int32
source and window origin, and one int32 SAD per MB and offset, each read
or written once (chip_smoke.py's bound); instructions, one 32-bit integer
lane instruction per 4 pixels and offset: the fewest that can form every
absolute difference of packed bytes and add it in (PTX `vabsdiff4.add`,
one SASS VABSDIFF4; the kernel issues two, `__vabsdiffu4` and `__dp4a`).
"""
TARGET = "libvpx_opencl_tpu_torch.ops.me_sad:_launch"
KERNEL = "sad_grid_kernel"


def capture(args, kwargs):
    """(reference plane bytes, MBs, search range)."""
    ref_plane, src, rng = args[0], args[3], args[5]
    return ref_plane.numel(), src.shape[0], rng


def work(rec):
    plane, n, rng = rec
    n_off = (2 * rng + 1) ** 2
    return (plane + n * (256 * 4 + 8) + n * n_off * 4,
            n * n_off * 256 // 4)
