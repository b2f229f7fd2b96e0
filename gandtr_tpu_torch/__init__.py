"""PyTorch / CUDA port of gandtr_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX package: it imports `torch` and nothing
of `jax`, `flax` or `gandtr_tpu`. Module names follow the JAX package so
each counterpart is easy to find. Public functions take and return NHWC
tensors like the JAX package; any NCHW layout is internal.

Entry points (`hub.*`, `serving.Servable`, `serving.serve_http`) run on
`cuda` unless the caller passes `device="cpu"` (see `device.py`).
"""
