"""Global pooling ops for descriptor networks (counterpart of
gandtr_tpu/ops/pooling.py). x: (N, H, W, C) -> (N, C), NHWC like the JAX
package; a channels-last NCHW tensor permuted to NHWC is a free view."""
import torch


def mac(x):
    """Max pooling over the spatial dims."""
    return x.amax(dim=(1, 2))


def spoc(x):
    """Average pooling over the spatial dims."""
    return x.mean(dim=(1, 2))


def gem(x, p=3.0, eps=1e-6, mask=None):
    """Generalized mean: mean(clamp(x, eps)^p)^(1/p) over H, W. `p` is a
    scalar or a 0-d / (1,) tensor (the learnable GeM parameter). With
    `mask` (N, H, W) the mean runs over the valid positions only (a padded
    bucket)."""
    xp = x.clamp(min=eps).pow(p)
    if mask is None:
        return xp.mean(dim=(1, 2)).pow(1.0 / p)
    m = mask[..., None].to(x.dtype)
    return ((xp * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2))).pow(1.0 / p)
