"""Wrapper of K2, the 3x3 SAME convolution of VGG16's 64- and 128-channel
layers (csrc/vggconv.cu).

Replaces gandtr_tpu/ops/vggconv_pallas.py::conv3x3_same on the TPU. Its
plain PyTorch version is ops/vggconv.py::conv3x3_same_plain, which
ops/vggconv.py's dispatch takes for CPU tensors; this wrapper takes CUDA
tensors only and launches the kernel or raises -- it never falls back.

`LAUNCHES` counts forward convolutions that launched the kernel.
"""
import ctypes

import torch

LAUNCHES = 0

_LIB = None


def _lib():
    """The built library with its C signature declared (built at first use:
    importing this module compiles nothing)."""
    global _LIB
    if _LIB is None:
        from gandtr_tpu_torch.kernels import _build
        lib = _build.load("vggconv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vggconv_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.vggconv_launch.restype = i
        lib.vggconv_error_string.argtypes = [i]
        lib.vggconv_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name, t, shape, dtype, dev):
    if t.device != dev:
        raise ValueError("%s is on %s, x on %s" % (name, t.device, dev))
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s must be %s, got %s" % (name, tuple(shape),
                                                    tuple(t.shape)))
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("%s must be contiguous and 16-byte aligned" % name)


def conv3x3_same_cuda(x, wmat, bias, relu=False, out_dtype=torch.bfloat16):
    """K2 on a CUDA bf16 NHWC-contiguous x (N, H, W, C), C in {64, 128};
    wmat: (9*C, C) bf16, the HWIO weight flattened; bias: (C,) float32.
    -> (N, H, W, C) in out_dtype (bfloat16 or float32)."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError("conv3x3_same_cuda needs a CUDA tensor, got %s"
                         % x.device)
    if x.dim() != 4 or x.shape[-1] not in (64, 128) or min(x.shape) == 0:
        raise ValueError("conv3x3_same_cuda needs (N, H, W, C) with C in "
                         "(64, 128), got %s" % (tuple(x.shape),))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("out_dtype must be bfloat16 or float32, got %s"
                        % out_dtype)
    N, H, W, C = x.shape
    dev = x.device
    _check("x", x, (N, H, W, C), torch.bfloat16, dev)
    _check("wmat", wmat, (9 * C, C), torch.bfloat16, dev)
    _check("bias", bias, (C,), torch.float32, dev)
    lib = _lib()
    out = torch.empty((N, H, W, C), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vggconv_launch(x.data_ptr(), wmat.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), N, H, W, C,
                                 int(bool(relu)),
                                 int(out_dtype == torch.float32), stream)
    if err:
        raise RuntimeError("vggconv kernel launch failed: %s"
                           % lib.vggconv_error_string(err).decode())
    LAUNCHES += 1
    return out
