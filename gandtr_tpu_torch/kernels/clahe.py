"""Wrapper of K1, the static CLAHE kernel pair (csrc/clahe.cu).

Replaces gandtr_tpu/ops/clahe_pallas.py::clahe_u8_pallas on the TPU. Its
plain PyTorch version is ops/clahe.py::clahe_u8_plain, which ops/clahe.py's
dispatch takes for CPU tensors; this wrapper takes CUDA tensors only and
launches the kernels or raises -- it never falls back.

`LAUNCHES` counts calls that launched the kernel pair (one LUT kernel and one
interpolation kernel for the whole batch).
"""
import ctypes

import torch

from gandtr_tpu_torch.ops.clahe import _grid, clahe_geometry

LAUNCHES = 0

_LIB = None


def _lib():
    """The built library with its C signatures declared (built at first use:
    importing this module compiles nothing)."""
    global _LIB
    if _LIB is None:
        from gandtr_tpu_torch.kernels import _build
        lib = _build.load("clahe")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.clahe_u8_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                        ctypes.c_float, p]
        lib.clahe_u8_launch.restype = i
        lib.clahe_error_string.argtypes = [i]
        lib.clahe_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def clahe_u8_cuda(img, clip_limit=4.0, grid_size=(8, 8)):
    """K1 on a CUDA uint8 batch (N, H, W) or image (H, W) -> same shape."""
    global LAUNCHES
    if img.device.type != "cuda":
        raise ValueError("clahe_u8_cuda needs a CUDA tensor, got %s"
                         % img.device)
    if img.dtype != torch.uint8:
        raise TypeError("clahe_u8_cuda needs uint8, got %s" % img.dtype)
    if img.dim() not in (2, 3) or min(img.shape) == 0:
        raise ValueError("clahe_u8_cuda needs (N, H, W) or (H, W), got %s"
                         % tuple(img.shape))
    if not img.is_contiguous():
        raise ValueError("clahe_u8_cuda needs a contiguous tensor")
    squeeze = img.dim() == 2
    x = img[None] if squeeze else img
    N, H, W = x.shape
    ty, tx = _grid(grid_size)
    tile_h, tile_w, climit, lut_scale = clahe_geometry(H, W, clip_limit,
                                                       (ty, tx))
    lib = _lib()
    luts = torch.empty((N, ty * tx, 256), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.clahe_u8_launch(x.data_ptr(), luts.data_ptr(),
                                  out.data_ptr(), N, H, W, ty, tx, tile_h,
                                  tile_w, climit, float(lut_scale), stream)
    if err:
        raise RuntimeError("clahe kernel launch failed: %s"
                           % lib.clahe_error_string(err).decode())
    LAUNCHES += 1
    return out[0] if squeeze else out
