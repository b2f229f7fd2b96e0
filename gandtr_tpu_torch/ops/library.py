"""K1 and K3 as PyTorch custom operators: `torch.ops.gandtr.clahe_u8` and
`torch.ops.gandtr.fused_resblock`.

The kernels are bound through ctypes and read their tensors' data pointers,
which `torch.export` cannot trace (its fake tensors hold no data). As custom
operators they trace as one graph node each, and an exported program calls
them through the same registrations as eager code:

- the CPU implementation is the plain PyTorch version (ops/clahe.py,
  ops/resblock.py);
- the CUDA implementation is the kernel's wrapper (kernels/clahe.py,
  kernels/resblock.py), which launches the kernel or raises: no fallback,
  and its `LAUNCHES` counts launches made from inside a loaded artifact
  too;
- the fake implementation gives the output's shape and dtype.

Importing this module registers the operators; it compiles nothing. The
implementations import their modules when called, so ops/clahe.py and
ops/resblock.py can import this one.
"""
import torch


@torch.library.custom_op("gandtr::clahe_u8", mutates_args=(),
                         device_types="cpu")
def clahe_u8(img: torch.Tensor, clip_limit: float, grid_h: int,
             grid_w: int) -> torch.Tensor:
    """Static CLAHE of a uint8 (N, H, W) or (H, W) tensor (K1)."""
    from gandtr_tpu_torch.ops.clahe import clahe_u8_plain
    return clahe_u8_plain(img, clip_limit, (grid_h, grid_w))


@clahe_u8.register_kernel("cuda")
def _clahe_u8_cuda(img, clip_limit, grid_h, grid_w):
    from gandtr_tpu_torch.kernels import clahe as kclahe
    # an exported program keeps the layout it traced; contiguous() is a
    # no-op on the layout the eager path gives
    return kclahe.clahe_u8_cuda(img.contiguous(), clip_limit,
                                (grid_h, grid_w))


@clahe_u8.register_fake
def _clahe_u8_fake(img, clip_limit, grid_h, grid_w):
    if img.dtype != torch.uint8 or img.dim() not in (2, 3):
        raise ValueError("clahe_u8 takes uint8 (N, H, W) or (H, W), got %s %s"
                         % (img.dtype, tuple(img.shape)))
    return torch.empty_like(img)


@torch.library.custom_op("gandtr::fused_resblock", mutates_args=(),
                         device_types="cpu")
def fused_resblock(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """The ResNet-generator block at inference (K3): x (N, H, W, C), w
    (3, 3, C, C) HWIO, b (C,); -> (N, H, W, C) bf16."""
    from gandtr_tpu_torch.ops.resblock import fused_resblock_plain
    return fused_resblock_plain(x, w1, b1, w2, b2, eps)


@fused_resblock.register_kernel("cuda")
def _fused_resblock_cuda(x, w1, b1, w2, b2, eps):
    from gandtr_tpu_torch.kernels import resblock as kres
    C = x.shape[-1]
    return kres.fused_resblock_cuda(
        x.contiguous(), w1.contiguous().view(9 * C, C), b1.contiguous(),
        w2.contiguous().view(9 * C, C), b2.contiguous(), eps)


@fused_resblock.register_fake
def _fused_resblock_fake(x, w1, b1, w2, b2, eps):
    if x.dim() != 4 or tuple(w1.shape) != (3, 3) + (x.shape[-1],) * 2:
        raise ValueError("fused_resblock takes x (N, H, W, C) and (3, 3, C, "
                         "C) weights, got %s and %s"
                         % (tuple(x.shape), tuple(w1.shape)))
    return torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
