"""Descriptor whitening, apply only (counterpart of
gandtr_tpu/ops/whiten.py::whitenapply). Learning stays on the host in the
JAX package's float64 numpy code for now."""
import torch


def whitenapply(X, m, P, dimensions=None):
    """P[:d] @ (X - m), columns L2-normalized. X: (D, N) in the reference's
    column convention; m: (D, 1)."""
    if not dimensions:
        dimensions = P.shape[0]
    X = P[:dimensions, :] @ (X - m)
    return X / (torch.linalg.vector_norm(X, dim=0, keepdim=True) + 1e-6)
