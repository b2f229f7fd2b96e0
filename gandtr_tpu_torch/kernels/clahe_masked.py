"""Wrapper of the CLAHE kernel (csrc/clahe.cu) in masked mode: K4, masked
CLAHE with its LUT build.

Replaces gandtr_tpu/ops/clahe_pallas.py::masked_interp_pallas on the TPU,
and the XLA LUT build in front of it. Its plain PyTorch version is
ops/clahe.py::clahe_u8_masked_plain, which ops/clahe.py's dispatch takes for
CPU tensors; this wrapper takes CUDA tensors only and launches the kernel or
raises -- it never falls back. The valid sizes stay on the device.

`LAUNCHES` counts calls that launched the kernel (one launch for the whole
batch: LUTs and interpolation in one kernel).
"""
import torch

# _lib: the library this wrapper launches, as every wrapper module has it
from gandtr_tpu_torch.kernels.clahe import _lib, launch  # noqa: F401

LAUNCHES = 0


def clahe_u8_masked_cuda(img, hw, clip_limit=4.0, grid_size=(8, 8)):
    """K4 on a CUDA uint8 bucket (N, H, W) with valid sizes hw (N, 2) int32
    on the same device -> (N, H, W) uint8, 0 outside each rectangle."""
    global LAUNCHES
    if not img.is_cuda:
        raise ValueError("clahe_u8_masked_cuda needs a CUDA tensor, got %s"
                         % img.device)
    if img.dtype != torch.uint8 or img.dim() != 3 or min(img.shape) == 0:
        raise ValueError("clahe_u8_masked_cuda needs uint8 (N, H, W), got %s "
                         "%s" % (img.dtype, tuple(img.shape)))
    N = img.shape[0]
    if hw.get_device() != img.get_device() or hw.dtype != torch.int32 \
            or tuple(hw.shape) != (N, 2):
        raise ValueError("hw must be int32 (%d, 2) on %s, got %s %s on %s"
                         % (N, img.device, hw.dtype, tuple(hw.shape),
                            hw.device))
    if not (img.is_contiguous() and hw.is_contiguous()):
        raise ValueError("clahe_u8_masked_cuda needs contiguous tensors")
    out = torch.empty_like(img)
    launch(img, hw, out, clip_limit, grid_size)
    LAUNCHES += 1
    return out
