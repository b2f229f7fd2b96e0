"""Wrapper of the CLAHE kernel (csrc/clahe.cu) in static mode: K1.

Replaces gandtr_tpu/ops/clahe_pallas.py::clahe_u8_pallas on the TPU. Its
plain PyTorch version is ops/clahe.py::clahe_u8_plain, which ops/clahe.py's
dispatch takes for CPU tensors; this wrapper takes CUDA tensors only and
launches the kernel or raises -- it never falls back. `launch` is shared
with K4's wrapper (kernels/clahe_masked.py), which runs the same kernel in
masked mode.

`LAUNCHES` counts calls that launched the kernel (one launch for the whole
batch: LUTs and interpolation in one kernel).
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
        lib = _build.load("clahe")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.clahe_launch.argtypes = [p, p, p, i, i, i, i, i, ctypes.c_double,
                                     p]
        lib.clahe_launch.restype = i
        lib.clahe_error_string.argtypes = [i]
        lib.clahe_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(img, hw, out, clip_limit, grid_size):
    """One launch of the CLAHE kernel on img's current stream: img, out
    contiguous uint8 (N, H, W) on one CUDA device; hw an int32 (N, 2) tensor
    there (masked mode) or None (static mode). Raises if the launch fails."""
    lib = _LIB or _lib()
    index = img.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch(img, hw, out, clip_limit, grid_size)
    ty, tx = _grid(grid_size)
    N, H, W = img.shape
    err = lib.clahe_launch(img.data_ptr(),
                           None if hw is None else hw.data_ptr(),
                           out.data_ptr(), N, H, W, ty, tx, float(clip_limit),
                           # the current stream by torch's C accessor (which
                           # Triton's launcher calls too): 0.14 us against
                           # 4.2 for torch.cuda.current_stream() on an H100
                           # host (scripts/torch_kernel_ab.py)
                           torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError("clahe kernel launch failed: %s"
                           % lib.clahe_error_string(err).decode())


def clahe_u8_cuda(img, clip_limit=4.0, grid_size=(8, 8)):
    """K1 on a CUDA uint8 batch (N, H, W) or image (H, W) -> same shape."""
    global LAUNCHES
    if not img.is_cuda:
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
    out = torch.empty_like(x)
    launch(x, None, out, clip_limit, grid_size)
    LAUNCHES += 1
    return out[0] if squeeze else out
