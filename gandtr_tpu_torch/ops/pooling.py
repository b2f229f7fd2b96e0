"""Global pooling ops for descriptor networks (counterpart of
gandtr_tpu/ops/pooling.py). x: (N, H, W, C) -> (N, C), NHWC like the JAX
package; a channels-last NCHW tensor permuted to NHWC is a free view.

With `mask` (N, H, W), images padded into a bucket pool over their valid
positions only (mac, spoc, gem).

Regional pooling (cirtorch's functional.py:26-126 and Rpool,
layers/pooling.py:76-113): `rmac` sums the L2-normalized max-pools of the
R-MAC regions, `roipool` pools each region and `rpool` aggregates them,
each region whitened. The region grid depends on the shape only and is
made on the host (`_rmac_regions`).

Under a row-sharded grid (parallel/spatial.py) mac, spoc and gem take the
maximum or the sums of their bands over the grid's sp group (every rank
of a data row then holds the same descriptor); a mask and the regional
poolings refuse it (ROADMAP A.6.6)."""
import math

import numpy as np
import torch

from gandtr_tpu_torch.parallel import spatial


def _banded(mask, what):
    """The active row-sharded grid, refusing a mask under it."""
    sm = spatial.banded()
    if sm is not None and mask is not None:
        spatial.refuse("%s over a mask" % what)
    return sm


def _band_mean(x, sm):
    """The mean over (H, W) of the image whose band is x: float32 sums and
    the bands' counts all-reduced over sp, rounded once to x's dtype."""
    return spatial.sp_mean(x.float(), sm)[:, 0, 0].to(x.dtype)


def mac(x, mask=None):
    """Max pooling over the spatial dims."""
    sm = _banded(mask, "mac")
    if sm is not None:
        return spatial.sp_amax(x, sm)
    if mask is not None:
        x = x.masked_fill(~(mask[..., None] > 0), float("-inf"))
    return x.amax(dim=(1, 2))


def spoc(x, mask=None):
    """Average pooling over the spatial dims."""
    sm = _banded(mask, "spoc")
    if sm is not None:
        return _band_mean(x, sm)
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
    sm = _banded(mask, "gem")
    xp = x.clamp(min=eps).pow(p)
    if sm is not None:
        return _band_mean(xp, sm).pow(1.0 / p)
    if mask is None:
        return xp.mean(dim=(1, 2)).pow(1.0 / p)
    m = mask[..., None].to(x.dtype)
    return ((xp * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2))).pow(1.0 / p)


def _rmac_regions(W, H, L=3):
    """The R-MAC region grid [(y, x, size)] of an H x W map, the JAX
    package's `_rmac_regions` bit for bit: cirtorch computes the region
    count in float32 tensors, and its argmin has exact ties (H=18, W=10:
    |0.6 - 0.1 b| at b=8 and b=4) that float32 and float64 break
    differently, so the count is computed in float32 here too."""
    f32 = np.float32
    ovr = f32(0.4)
    steps = np.arange(2, 8, dtype=np.float32)
    w = min(W, H)
    b = f32(max(H, W) - w) / (steps - f32(1))
    val = np.abs((f32(w * w) - f32(w) * b) / f32(w * w) - ovr)
    idx = int(np.argmin(val))  # the first minimum, as torch.min
    Wd = idx + 1 if H < W else 0
    Hd = idx + 1 if H > W else 0

    regions = []
    for l in range(1, L + 1):
        wl = math.floor(2 * w / (l + 1))
        wl2 = math.floor(wl / 2 - 1)
        if wl == 0:
            continue
        # centres: a float32 iota times the step (a Python float taken in
        # float32), plus wl2, floored in float32
        bW = 0.0 if l + Wd == 1 else (W - wl) / (l + Wd - 1)
        cenW = np.floor(f32(wl2) + np.arange(l - 1 + Wd + 1, dtype=np.float32)
                        * f32(bW)).astype(np.int64) - wl2
        bH = 0.0 if l + Hd == 1 else (H - wl) / (l + Hd - 1)
        cenH = np.floor(f32(wl2) + np.arange(l - 1 + Hd + 1, dtype=np.float32)
                        * f32(bH)).astype(np.int64) - wl2
        for i_ in cenH:
            for j_ in cenW:
                regions.append((int(i_), int(j_), wl))
    return regions


def _region(x, i, j, wl):
    """x[:, i:i+wl, j:j+wl], the start clamped into the map as
    `jax.lax.dynamic_slice` clamps it."""
    H, W = x.shape[1:3]
    i, j = min(max(i, 0), H - wl), min(max(j, 0), W - wl)
    return x[:, i:i + wl, j:j + wl]


def _unit(v, eps):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def rmac(x, L=3, eps=1e-6):
    """Regional MAC (functional.py:26-75): the L2-normalized global max-pool
    plus each region's. (N, H, W, C) -> (N, C)."""
    spatial.refuse("R-MAC")
    H, W = x.shape[1:3]
    v = _unit(mac(x), eps)
    for i, j, wl in _rmac_regions(W, H, L):
        v = v + _unit(mac(_region(x, i, j, wl)), eps)
    return v


def roipool(x, rpool_fn, L=3):
    """The global map and each R-MAC region pooled by `rpool_fn`
    (functional.py:78-126): (N, H, W, C) -> (N, R, C)."""
    spatial.refuse("regional pooling")
    H, W = x.shape[1:3]
    vecs = [rpool_fn(x)] + [rpool_fn(_region(x, i, j, wl))
                            for i, j, wl in _rmac_regions(W, H, L)]
    return torch.stack(vecs, dim=1)


def rpool(x, rpool_fn, whiten_fn=None, L=3, eps=1e-6):
    """Regional pooling: each region pooled and L2-normalized, whitened by
    `whiten_fn` and normalized again, summed and normalized (cirtorch's
    Rpool). (N, H, W, C) -> (N, C)."""
    o = _unit(roipool(x, rpool_fn, L), eps)
    if whiten_fn is not None:
        o = _unit(whiten_fn(o), eps)
    return _unit(o.sum(dim=1), eps)


POOLINGS = {"mac": mac, "spoc": spoc, "gem": gem, "rmac": rmac}
