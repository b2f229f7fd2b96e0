"""Normalization ops (counterpart of gandtr_tpu/ops/norm.py), NHWC.

Under bfloat16 they round where jnp does: `jnp.mean` and `jnp.var` sum in
float32 and round the result once to bf16; every elementwise op rounds to
bf16; a Python scalar is taken in the array's dtype (jnp's weak typing).
A float32 statistic beside a bf16 tensor promotes the result to float32, as
in JAX.

Under a row-sharded grid (parallel/spatial.py) instance norm's two passes
are two sums all-reduced over the grid's sp group.
"""
import torch

from gandtr_tpu_torch.parallel import spatial


def l2n(x, eps=1e-6, dim=-1):
    """x / (||x||_2 + eps) along `dim` (channel-last by default)."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def instance_norm(x, eps=1e-5):
    """Per-sample, per-channel spatial normalization of (N, H, W, C):
    torch InstanceNorm2d (biased variance, eps inside the sqrt)."""
    v = x.float()
    if spatial.banded() is not None:
        mean, var = spatial.spatial_moments(v)
    else:
        mean = v.mean(dim=(1, 2), keepdim=True)
        var = ((v - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    return (x - mean) / torch.sqrt(var + torch.tensor(eps, dtype=x.dtype))


def batch_norm_inference(x, mean, var, gamma, beta, eps=1e-5):
    """Frozen-eval batch norm over the last axis; stats are (C,)."""
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta
