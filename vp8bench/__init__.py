"""Benchmark of the PyTorch/CUDA VP8 port (`libvpx_opencl_tpu_torch`).

`python3 vp8bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on a CUDA card. The
harness (`harness/`) is driven by data: each configuration, traffic mix,
workload, generator, driver, end-to-end metric, per-layer metric and kernel
roofline is a file of its own, found by the name BENCHMARK.json gives it.
"""
