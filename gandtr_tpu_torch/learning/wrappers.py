"""Network wrappers (counterpart of gandtr_tpu/learning/wrappers.py): each
wrapper is a pair `pre(x, ctx) -> (x, meta)` / `post(y, ctx, meta) -> y`
composed around a model forward. NHWC batches in, (N, D) descriptors out.

Ported so far: the eval chain of the descriptor hub models, multiscale
aggregation and learned whitening.
"""
import numpy as np
import torch

from gandtr_tpu_torch.ops.resize import scale_resize


class ScaleList(list):
    """Marker: a wrapper expanded the input into per-scale batches; the model
    forward maps over it."""


class Wrapper:
    def pre(self, x, ctx):
        return x, None

    def post(self, y, ctx, meta):
        return y


class CirMultiscaleAggregation(Wrapper):
    """Run the model at each scale, p-power-mean the descriptors,
    renormalize. The power is ctx["msp"] (GeM p of a plain GeM net), and 1
    for a single scale."""

    def __init__(self, scales=True):
        if isinstance(scales, bool):
            scales = [1, 1 / np.sqrt(2), 1 / 2] if scales else [1]
        self.scales = list(scales)

    def pre(self, x, ctx):
        return ScaleList([scale_resize(x, s) if s != 1 else x
                          for s in self.scales]), None

    def post(self, descs, ctx, meta):
        """descs: list of (N, D) descriptor batches, one per scale."""
        msp = ctx.get("msp", 1.0) if len(self.scales) > 1 else 1.0
        v = sum(d ** msp for d in descs) / len(self.scales)
        v = v ** (1.0 / msp)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


class CirtorchWhiten(Wrapper):
    """Learned whitening: X = P[:d] (x - m), L2-normalized (with +1e-6, as
    the reference's whitenapply)."""

    def __init__(self, P, m, dimensions=None, device="cpu"):
        self.P = torch.as_tensor(np.asarray(P, np.float32), device=device)
        self.m = torch.as_tensor(np.asarray(m, np.float32),
                                 device=device).reshape(-1)
        self.dimensions = dimensions or self.P.shape[0]

    def post(self, y, ctx, meta):
        X = (y - self.m[None, :]) @ self.P[:self.dimensions, :].T
        return X / (torch.linalg.vector_norm(X, dim=-1, keepdim=True) + 1e-6)


def apply_wrapped(wrappers, forward, x, ctx=None):
    """Compose pre/post around a forward; a ScaleList from a `pre` maps the
    forward over its items."""
    ctx = ctx or {}
    metas = []
    for w in wrappers:
        x, meta = w.pre(x, ctx)
        metas.append(meta)
    if isinstance(x, ScaleList):
        y = [forward(xi) for xi in x]
    else:
        y = forward(x)
    for w, meta in reversed(list(zip(wrappers, metas))):
        y = w.post(y, ctx, meta)
    return y
