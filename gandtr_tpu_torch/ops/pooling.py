"""Global pooling ops for descriptor networks (counterpart of
gandtr_tpu/ops/pooling.py). x: (N, H, W, C) -> (N, C), NHWC like the JAX
package; a channels-last NCHW tensor permuted to NHWC is a free view.

With `mask` (N, H, W), images padded into a bucket pool over their valid
positions only."""
import torch


def mac(x, mask=None):
    """Max pooling over the spatial dims."""
    if mask is not None:
        x = x.masked_fill(~(mask[..., None] > 0), float("-inf"))
    return x.amax(dim=(1, 2))


def spoc(x, mask=None):
    """Average pooling over the spatial dims."""
    if mask is not None:
        m = mask[..., None].to(x.dtype)
        return (x * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2))
    return x.mean(dim=(1, 2))


def gem(x, p=3.0, eps=1e-6, mask=None):
    """Generalized mean: mean(clamp(x, eps)^p)^(1/p) over H, W. `p` is a
    scalar, a 0-d / (1,) tensor (the learnable GeM parameter) or a (C,)
    tensor (GeMmp), taken in x's dtype as the JAX package does. With
    `mask` (N, H, W) the mean runs over the valid positions only (a padded
    bucket)."""
    if torch.is_tensor(p):
        p = p.to(x.dtype)
    xp = x.clamp(min=eps).pow(p)
    if mask is None:
        return xp.mean(dim=(1, 2)).pow(1.0 / p)
    m = mask[..., None].to(x.dtype)
    return ((xp * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2))).pow(1.0 / p)


POOLINGS = {"mac": mac, "spoc": spoc, "gem": gem}
