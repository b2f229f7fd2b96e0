"""Wrapper of K4, masked CLAHE with its LUT build (csrc/clahe_masked.cu).

Replaces gandtr_tpu/ops/clahe_pallas.py::masked_interp_pallas on the TPU,
and the XLA LUT build in front of it. Its plain PyTorch version is
ops/clahe.py::clahe_u8_masked_plain, which ops/clahe.py's dispatch takes for
CPU tensors; this wrapper takes CUDA tensors only and launches the kernels
or raises -- it never falls back. The valid sizes stay on the device.

`LAUNCHES` counts calls that launched the kernel pair (one LUT kernel and one
interpolation kernel for the whole batch).
"""
import ctypes

import torch

from gandtr_tpu_torch.ops.clahe import _grid

LAUNCHES = 0

_LIB = None


def _lib():
    """The built library with its C signatures declared (built at first use:
    importing this module compiles nothing)."""
    global _LIB
    if _LIB is None:
        from gandtr_tpu_torch.kernels import _build
        lib = _build.load("clahe_masked")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.clahe_masked_launch.argtypes = [p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, p]
        lib.clahe_masked_launch.restype = i
        lib.clahe_masked_error_string.argtypes = [i]
        lib.clahe_masked_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def clahe_u8_masked_cuda(img, hw, clip_limit=4.0, grid_size=(8, 8)):
    """K4 on a CUDA uint8 bucket (N, H, W) with valid sizes hw (N, 2) int32
    on the same device -> (N, H, W) uint8, 0 outside each rectangle."""
    global LAUNCHES
    if img.device.type != "cuda":
        raise ValueError("clahe_u8_masked_cuda needs a CUDA tensor, got %s"
                         % img.device)
    if img.dtype != torch.uint8 or img.dim() != 3 or min(img.shape) == 0:
        raise ValueError("clahe_u8_masked_cuda needs uint8 (N, H, W), got %s "
                         "%s" % (img.dtype, tuple(img.shape)))
    N, H, W = img.shape
    if hw.device != img.device or hw.dtype != torch.int32 \
            or tuple(hw.shape) != (N, 2):
        raise ValueError("hw must be int32 (%d, 2) on %s, got %s %s on %s"
                         % (N, img.device, hw.dtype, tuple(hw.shape),
                            hw.device))
    if not (img.is_contiguous() and hw.is_contiguous()):
        raise ValueError("clahe_u8_masked_cuda needs contiguous tensors")
    ty, tx = _grid(grid_size)
    lib = _lib()
    luts = torch.empty((N, ty * tx, 256), dtype=torch.uint8, device=img.device)
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.clahe_masked_launch(img.data_ptr(), hw.data_ptr(),
                                      luts.data_ptr(), out.data_ptr(), N, H,
                                      W, ty, tx, float(clip_limit), stream)
    if err:
        raise RuntimeError("masked clahe kernel launch failed: %s"
                           % lib.clahe_masked_error_string(err).decode())
    LAUNCHES += 1
    return out
