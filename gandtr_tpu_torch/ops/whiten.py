"""Descriptor whitening (counterpart of gandtr_tpu/ops/whiten.py; the
reference's cirtorch/utils/whiten.py). Descriptor matrices follow the
reference's D x N column convention.

Learning runs on the host in float64 numpy, as the reference's
eigendecomposition does: it is done once a fine-tune, on a few thousand
descriptors. Applying runs on the descriptors' device.
"""
import numpy as np
import torch


def whitenapply(X, m, P, dimensions=None):
    """P[:d] @ (X - m), columns L2-normalized. X: (D, N) in the reference's
    column convention; m: (D, 1)."""
    if not dimensions:
        dimensions = P.shape[0]
    X = P[:dimensions, :] @ (X - m)
    return X / (torch.linalg.vector_norm(X, dim=0, keepdim=True) + 1e-6)


def _eig_descending(S):
    eigval, eigvec = np.linalg.eigh(S)
    order = eigval.argsort()[::-1]
    return eigval[order], eigvec[:, order]


def pcawhitenlearn(X, shrink=None):
    """PCA whitening from unannotated descriptors (whiten.py:15-36):
    (m (D, 1), P (D, D))."""
    X = np.asarray(X, dtype=np.float64)
    N = X.shape[1]
    m = X.mean(axis=1, keepdims=True)
    Xc = X - m
    Xcov = Xc @ Xc.T
    Xcov = (Xcov + Xcov.T) / (2 * N)
    eigval, eigvec = _eig_descending(Xcov)
    if shrink:
        b = eigval[shrink - 1]
        eigval = (1 - b) * eigval + b
    P = np.linalg.inv(np.sqrt(np.diag(eigval))) @ eigvec.T
    return m, P


def _jittered_cholesky(S):
    """Cholesky with a diagonal jitter that grows (1e-10, then x10) until
    S + jitter is positive definite (whiten.py:55-70)."""
    alpha = 0.0
    while True:
        try:
            return np.linalg.cholesky(S + alpha * np.eye(*S.shape))
        except np.linalg.LinAlgError:
            alpha = 1e-10 if alpha == 0 else alpha * 10


def whitenlearn(X, qidxs, pidxs):
    """Learned (Lw) whitening from query / positive pairs (whiten.py:38-53):
    (m (D, 1), P (D, D))."""
    X = np.asarray(X, dtype=np.float64)
    m = X[:, qidxs].mean(axis=1, keepdims=True)
    df = X[:, qidxs] - X[:, pidxs]
    S = df @ df.T / df.shape[1]
    P = np.linalg.inv(_jittered_cholesky(S))
    df = P @ (X - m)
    _, eigvec = _eig_descending(df @ df.T)
    return m, eigvec.T @ P


def whitenlearn_with_retry(X, qidxs, pidxs, max_trials=100, seed=0):
    """whitenlearn, retried on a linear-algebra failure with a shrinking
    random subset of the pairs (the reference's stages/whiten.py:48-67)."""
    rng = np.random.RandomState(seed)
    qidxs = np.asarray(qidxs)
    pidxs = np.asarray(pidxs)
    for trial in range(max_trials):
        keep = max(int(round(len(qidxs) * (1 - 0.95 * trial / max_trials))),
                   2)
        sel = (np.sort(rng.choice(len(qidxs), keep, replace=False)) if trial
               else np.arange(len(qidxs)))
        try:
            return whitenlearn(X, qidxs[sel], pidxs[sel])
        except np.linalg.LinAlgError:
            continue
    raise RuntimeError("whitenlearn failed after %d trials" % max_trials)
