"""Extra model layers (counterpart of gandtr_tpu/models/extra_layers.py;
the reference's layers/{pooling,attention,preprocessing}.py), NHWC: the
HORDE high-order regularizer, geometric-median pooling, the L2-norm
attention map and the learnable edge-map filter.
"""
import torch
from torch import nn


class HordeCascadedKOrder(nn.Module):
    """HORDE cascaded high-order pooling regularizer (layers/pooling.py:
    6-41): `order` 1x1 projections without bias (`proj.<i>`), their
    cascaded products average-pooled and embedded back to `dim` by linear
    maps without bias (`embed.<i>`). (N, H, W, dim) -> a list of order - 1
    (N, dim) embeddings."""

    def __init__(self, dim, order, high_order_dims):
        super().__init__()
        self.order = order
        n = order if order > 1 else 0
        self.proj = nn.ModuleList(nn.Conv2d(dim, high_order_dims, 1,
                                            bias=False) for _ in range(n))
        self.embed = nn.ModuleList(nn.Linear(high_order_dims, dim, bias=False)
                                   for _ in range(max(n - 1, 0)))

    def forward(self, x):
        if self.order <= 1:
            return []
        xc = x.permute(0, 3, 1, 2)
        proj = [p(xc).permute(0, 2, 3, 1) for p in self.proj]
        products = [proj[0] * proj[1]]
        for p in proj[2:]:
            products.append(products[-1] * p)
        return [e(h.mean(dim=(1, 2))) for e, h in zip(self.embed, products)]


def geometric_median_weiszfeld(x, iterations=3, intermediate_gradients=False):
    """Weiszfeld's iterations for the geometric median of each image's
    feature vectors (layers/pooling.py:44-68): (N, H, W, C) -> (N, 1, 1,
    C). The weights are computed on detached features unless
    `intermediate_gradients`; the last weighted mean takes x's gradient."""
    eff = x if intermediate_gradients else x.detach()
    w = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=x.dtype,
                   device=x.device)
    for _ in range(iterations):
        median = (eff * w).sum(dim=(1, 2), keepdim=True) / w.sum()
        w = 1.0 / torch.sqrt(((eff - median) ** 2).sum(dim=-1, keepdim=True)
                             + 1e-10)
    return (x * w).sum(dim=(1, 2), keepdim=True) / w.sum()


def weighted_geometric_median_weiszfeld(x, attention_map, iterations=3,
                                        intermediate_gradients=False):
    """The weighted form (layers/pooling.py:71-95); attention_map (N, H, W,
    1) weighs every position."""
    eff = x if intermediate_gradients else x.detach()
    w = attention_map
    for _ in range(iterations):
        median = (eff * w).sum(dim=(1, 2), keepdim=True) / w.sum()
        w = attention_map / torch.sqrt(
            ((eff - median) ** 2).sum(dim=-1, keepdim=True) + 1e-10)
    return (x * w).sum(dim=(1, 2), keepdim=True) / w.sum()


def l2norm_attention(x, normalize_max=True):
    """The spatial L2-norm attention map (layers/attention.py:4-15):
    (N, H, W, C) -> (N, H, W, 1), divided by each image's maximum."""
    m = torch.sqrt((x ** 2).sum(dim=-1, keepdim=True) + 1e-10)
    if normalize_max:
        m = m / m.amax(dim=(1, 2, 3), keepdim=True)
    return m


ATTENTIONS = {"l2norm": l2norm_attention}


class EdgeFilter(nn.Module):
    """The learnable edge-map filter (layers/preprocessing.py:9-29):
    w clamp(x, eps)^p / (exp(min(-beta (x - tau), 50)) + 1), with `p` and
    `tau` parameters of shape (1,). tau is clamped to [0.01, 0.9] in the
    forward, as the JAX package does; the reference clamps the parameter
    itself in place."""

    def __init__(self, w=10.0, p_init=0.5, beta=500.0, tau_init=0.1,
                 eps=1e-6):
        super().__init__()
        self.w, self.beta, self.eps = w, beta, eps
        self.p = nn.Parameter(torch.full((1,), float(p_init)))
        self.tau = nn.Parameter(torch.full((1,), float(tau_init)))

    def forward(self, x):
        tau = torch.clamp(self.tau, 0.01, 0.9)
        num = self.w * torch.clamp(x, min=self.eps) ** self.p
        den = torch.exp(torch.clamp(-self.beta * (x - tau), max=50.0)) + 1.0
        return num / den
