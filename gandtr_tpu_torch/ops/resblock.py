"""The ResNet-generator block at inference as one op (counterpart of
gandtr_tpu/ops/resblock_pallas.py).

    reflect-pad 1 -> 3x3 conv + bias -> instance norm -> ReLU
    -> reflect-pad 1 -> 3x3 conv + bias -> instance norm -> + x

in bf16 with float32 statistics. `fused_resblock` dispatches by the
tensor's device: a CPU tensor takes `fused_resblock_plain`, a CUDA tensor
launches K3 (kernels/resblock.py, csrc/resblock.cu) or raises. The
dispatch is the custom op `gandtr::fused_resblock` (ops/library.py), so
`torch.export` traces it as one node.

Both versions round where the JAX kernel does (resblock_pallas.py:65-160):
each conv takes bf16 operands and accumulates in float32, its result is
rounded to bf16 and the bf16 bias added as a bf16 add; the statistics are
float32 over the bf16 values, two passes (mean, then the mean of squared
deviations); the normalized, ReLU'd activation is rounded to bf16 before
conv2; the output is bf16((t2 - mean2) * inv2 + x). They differ from each
other and from the JAX kernel only in summation order (K3 takes each
output tile's mean and squared deviations and combines the tiles by Chan's
formula).
"""
import torch
import torch.nn.functional as F

from gandtr_tpu_torch.ops import library
from gandtr_tpu_torch.parallel import spatial

BF16 = torch.bfloat16


def _conv_round(a, w, b):
    """bf16(bf16(conv3x3(reflect1(a), w)) + b): a (N, H, W, C) bf16,
    w (3, 3, C, C) HWIO, b (C,); the conv is float32 on bf16 values."""
    xp = F.pad(a.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode="reflect")
    wt = w.to(BF16).float().permute(3, 2, 0, 1)
    acc = F.conv2d(xp, wt).permute(0, 2, 3, 1)
    return (acc.to(BF16).float() + b.to(BF16).float()).to(BF16)


def _stats(t, eps):
    """Per (n, c) float32 mean and 1/sqrt(biased var + eps) of bf16 t."""
    v = t.float()
    mean = v.mean(dim=(1, 2), keepdim=True)
    var = ((v - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    return v, mean, 1.0 / torch.sqrt(var + eps)


def fused_resblock_plain(x, w1, b1, w2, b2, eps=1e-5):
    """The plain PyTorch version of K3. x: (N, H, W, C); w: (3, 3, C, C)
    HWIO; b: (C,). Returns (N, H, W, C) bf16."""
    x = x.to(BF16)
    v, mean, inv = _stats(_conv_round(x, w1, b1), eps)
    a = torch.clamp_min((v - mean) * inv, 0.0).to(BF16)
    v, mean, inv = _stats(_conv_round(a, w2, b2), eps)
    return ((v - mean) * inv + x.float()).to(BF16)


def eligible(x_shape, dtype, *, train, use_dropout, padding_type, norm_type,
             use_bias):
    """Whether a block takes the fused op: resblock_pallas.py:213-229 without
    its TPU-only terms (the enable flag, the VMEM budget, H % 8, C % 128).
    `train` is true in training mode or when autograd records a graph: K3
    has no backward, as the JAX kernel has none. Under a row-sharded grid
    (parallel/spatial.py) it declines too: its instance-norm statistics
    cover only the rows it is given, where the block's cover the image
    (the layered block all-reduces them)."""
    if train or use_dropout or not use_bias:
        return False
    if spatial.banded() is not None:
        return False
    if padding_type != "reflect" or norm_type != "instance":
        return False
    if dtype != BF16 or len(x_shape) != 4:
        return False
    return x_shape[1] >= 2 and x_shape[2] >= 2


def fused_resblock(x, w1, b1, w2, b2, eps=1e-5):
    """Dispatch by device through the custom op `gandtr::fused_resblock`
    (ops/library.py). On CUDA, x must be NHWC-contiguous bf16 and the
    weights bf16 HWIO-contiguous (prepared once by the caller: nothing is
    transposed per call)."""
    return library.fused_resblock(x, w1, b1, w2, b2, float(eps))
