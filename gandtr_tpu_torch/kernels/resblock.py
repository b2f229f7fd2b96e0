"""Wrapper of K3, the fused ResNet-generator block (csrc/resblock.cu).

Replaces gandtr_tpu/ops/resblock_pallas.py::fused_resblock on the TPU. Its
plain PyTorch version is ops/resblock.py::fused_resblock_plain, which
ops/resblock.py's dispatch takes for CPU tensors; this wrapper takes CUDA
tensors only and launches the kernels or raises -- it never falls back.

`LAUNCHES` counts block calls that launched the kernels (five launches on
the stream per call: two convs, each with its tile statistics, two
finalizes, the residual).
"""
import ctypes

import torch

from gandtr_tpu_torch.kernels import conv3x3_plan

LAUNCHES = 0

_LIB = None


def _lib():
    """The built library with its C signature declared (built at first use:
    importing this module compiles nothing)."""
    global _LIB
    if _LIB is None:
        from gandtr_tpu_torch.kernels import _build
        lib = _build.load("resblock")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.resblock_launch.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float, p]
        lib.resblock_launch.restype = i
        lib.resblock_error_string.argtypes = [i]
        lib.resblock_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name, t, shape, dev):
    if t.device != dev:
        raise ValueError("%s is on %s, x on %s" % (name, t.device, dev))
    if t.dtype != torch.bfloat16:
        raise TypeError("%s must be bfloat16, got %s" % (name, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s must be %s, got %s" % (name, tuple(shape),
                                                    tuple(t.shape)))
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("%s must be contiguous and 16-byte aligned" % name)


def fused_resblock_cuda(x, wmat1, b1, wmat2, b2, eps=1e-5):
    """K3 on a CUDA bf16 NHWC-contiguous x (N, H, W, C); wmat: (9*C, C)
    bf16, the HWIO weights flattened; b: (C,) bf16. -> (N, H, W, C) bf16."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError("fused_resblock_cuda needs a CUDA tensor, got %s"
                         % x.device)
    if x.dim() != 4:
        raise ValueError("fused_resblock_cuda needs (N, H, W, C), got %s"
                         % (tuple(x.shape),))
    N, H, W, C = x.shape
    if C % 16 or C > 2048 or H < 2 or W < 2 or N < 1:
        raise ValueError("fused_resblock_cuda needs C %% 16 == 0, C <= 2048 "
                         "and H, W >= 2; got %s" % (tuple(x.shape),))
    dev = x.device
    _check("x", x, (N, H, W, C), dev)
    for name, t, shape in (("wmat1", wmat1, (9 * C, C)), ("b1", b1, (C,)),
                           ("wmat2", wmat2, (9 * C, C)), ("b2", b2, (C,))):
        _check(name, t, shape, dev)
    lib = _lib()
    geo = conv3x3_plan.geometry(H, W, C)
    tiles = geo.tiles_y * geo.tiles_x
    t1 = torch.empty_like(x)
    t2 = torch.empty_like(x)
    out = torch.empty_like(x)
    # each tile's (count, mean, M2) per channel
    partial = torch.empty((N * tiles * 3 * C,), dtype=torch.float32,
                          device=dev)
    stats = torch.empty((4 * N * C,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.resblock_launch(
            x.data_ptr(), wmat1.data_ptr(), b1.data_ptr(), wmat2.data_ptr(),
            b2.data_ptr(), t1.data_ptr(), t2.data_ptr(), out.data_ptr(),
            partial.data_ptr(), stats.data_ptr(), N, H, W, C, tiles,
            float(eps), stream)
    if err:
        raise RuntimeError("resblock kernel launch failed: %s"
                           % lib.resblock_error_string(err).decode())
    LAUNCHES += 1
    return out
