"""Hand-written CUDA kernels for Hopper, with their launch counters.

| Kernel | Source | Replaces (TPU) |
| --- | --- | --- |
| K1 `clahe.clahe_u8_cuda` | csrc/clahe.cu | gandtr_tpu/ops/clahe_pallas.py::clahe_u8_pallas |
| K3 `resblock.fused_resblock_cuda` | csrc/resblock.cu | gandtr_tpu/ops/resblock_pallas.py::fused_resblock |

Sources are compiled by `_build` at first use; nothing here imports or
builds CUDA code when the package is imported.
"""
