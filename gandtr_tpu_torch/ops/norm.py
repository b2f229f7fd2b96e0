"""Normalization ops (counterpart of gandtr_tpu/ops/norm.py)."""
import torch


def l2n(x, eps=1e-6, dim=-1):
    """x / (||x||_2 + eps) along `dim` (channel-last by default)."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)
