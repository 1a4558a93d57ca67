"""K6, the trellis (`csrc/trellis.cu`): one launch per inter frame over
its inter MBs, through `ops/rd_device.py:k6_launch`.

Least work: bytes, per MB its coefficients and levels (2 x 400 int32),
eobs (25 int32), three dequantizer pairs, levels and eobs written, and the
cost tables once (chip_smoke.py's bound). Instructions are not counted
(0): no sourced floor on what a trellis step must issue.
"""
TARGET = "libvpx_opencl_tpu_torch.ops.rd_device:k6_launch"
KERNEL = "trellis_kernel"
N_VALUES = 2115        # entries of the value-cost table (CAT6's span)


def capture(args, kwargs):
    """The launch's eobs [M, 25] int32 (its inputs' third tensor)."""
    return args[0][2]


def work(eobs):
    ni = eobs.shape[0]
    return (ni * (2 * 1600 + 100 + 24 + 1600 + 100) + 3 * 576 * 4
            + 3 * N_VALUES + 8, 0)
