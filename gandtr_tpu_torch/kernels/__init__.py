"""Hand-written CUDA kernels for Hopper, with their launch counters.

| Kernel | Source | Replaces (TPU) |
| --- | --- | --- |
| K1 `clahe.clahe_u8_cuda` | csrc/clahe.cu | gandtr_tpu/ops/clahe_pallas.py::clahe_u8_pallas |
| K2 `vggconv.conv3x3_same_cuda` | csrc/vggconv.cu | gandtr_tpu/ops/vggconv_pallas.py::conv3x3_same |
| K3 `resblock.fused_resblock_cuda` | csrc/resblock.cu | gandtr_tpu/ops/resblock_pallas.py::fused_resblock |
| K4 `clahe_masked.clahe_u8_masked_cuda` | csrc/clahe_masked.cu | gandtr_tpu/ops/clahe_pallas.py::masked_interp_pallas (and the LUT build of ops/clahe.py::clahe_u8_masked) |

Sources are compiled by `_build` at first use; nothing here imports or
builds CUDA code when the package is imported.
"""
