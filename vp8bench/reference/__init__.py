"""The plain references that decide `correct`. Nothing here imports the
program (`libvpx_opencl_tpu_torch`), JAX or the JAX package."""
