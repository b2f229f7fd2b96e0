"""GeM descriptor networks (counterpart of gandtr_tpu/models/retrieval.py).

features -> (local whiten) -> pool -> L2N -> (whiten -> L2N), as cirtorch's
ImageRetrievalNet. Module names follow that net (`features.<i>`, `pool.p`,
`lwhiten`, `whiten`; with `regional`, cirtorch's Rpool: `pool.rpool.p` and
`pool.whiten`), so a reference `.pth` loads with `load_state_dict`.
Backbones VGG16 (512-d) and ResNet-50/101/152 (2048-d); poolings gem,
gemmp (a p for each channel), mac and spoc, each over a mask too; rmac and
the dict form's GeometricMedianWeiszfeld at exact shapes only, as regional
pooling. Input (N, H, W, 3) normalized images, output (N, D) descriptors.

`GemRetrievalNetPreprocessing` (cirnet_inchan with `inputs.preprocessing`)
runs the learnable `EdgeFilter` (`preprocessing.p`, `preprocessing.tau`)
before the same net; `GemRetrievalNetAttention` (cirnet_attention) weighs
the features by their L2-norm attention map before the pooling.
"""
import torch
from torch import nn

from gandtr_tpu_torch.models.backbones import make_features
from gandtr_tpu_torch.models.extra_layers import (ATTENTIONS, EdgeFilter,
                                                  geometric_median_weiszfeld)
from gandtr_tpu_torch.ops import pooling as pool_ops
from gandtr_tpu_torch.ops.norm import l2n


class GeM(nn.Module):
    """Generalized-mean pooling with a learnable `p` of shape (1,), or
    (dim,) for GeMmp (one p a channel)."""

    def __init__(self, p=3.0, eps=1e-6, dim=1):
        super().__init__()
        self.p = nn.Parameter(torch.full((dim,), float(p)))
        self.eps = eps

    def forward(self, x, mask=None):
        """x: (N, H, W, C) -> (N, C); `mask` (N, H, W) restricts the mean
        to the valid positions."""
        return pool_ops.gem(x, p=self.p, eps=self.eps, mask=mask)


class ParameterFreePool(nn.Module):
    """MAC, SPoC (each over a mask too) or R-MAC (exact shapes only): no
    parameters."""

    def __init__(self, name):
        super().__init__()
        self.name = name

    def forward(self, x, mask=None):
        if self.name in ("mac", "spoc"):
            return pool_ops.POOLINGS[self.name](x, mask=mask)
        _no_mask(mask, self.name)
        return pool_ops.POOLINGS[self.name](x)


class GeometricMedianPool(nn.Module):
    """The dict form {type: GeometricMedianWeiszfeld, iterations,
    intermediate_gradients} (cirnet.py:61-63): (N, H, W, C) -> (N, C),
    exact shapes only."""

    def __init__(self, iterations=3, intermediate_gradients=False):
        super().__init__()
        self.iterations = int(iterations)
        self.intermediate_gradients = bool(intermediate_gradients)

    def forward(self, x, mask=None):
        _no_mask(mask, "GeometricMedianWeiszfeld")
        o = geometric_median_weiszfeld(x, self.iterations,
                                       self.intermediate_gradients)
        return o.reshape(o.shape[0], -1)


class Rpool(nn.Module):
    """cirtorch's Rpool (layers/pooling.py:76-113): the R-MAC regions
    pooled by `rpool`, each whitened by `whiten` (a learnable Linear),
    summed and L2-normalized. Exact shapes only."""

    def __init__(self, rpool, whiten):
        super().__init__()
        self.rpool, self.whiten = rpool, whiten

    def forward(self, x, mask=None):
        if mask is not None:
            raise ValueError("mask is not supported with regional pooling")
        return pool_ops.rpool(x, self.rpool, whiten_fn=self.whiten)


def _no_mask(mask, pooling):
    """A padded bucket would pool over its pad: refuse it."""
    if mask is not None:
        raise ValueError("mask is not supported with pooling %r" % pooling)


def make_pool(pooling, dim, gem_p_init=3.0, regional=False,
              pooling_params=None):
    """The pooling module of a GeM net: gem, gemmp, mac, spoc, rmac or
    GeometricMedianWeiszfeld (with `pooling_params`), or, `regional`, an
    Rpool over gem (a p of shape (1,)), mac, spoc or rmac."""
    if regional:
        if pooling == "gem":
            inner = GeM(gem_p_init)
        elif pooling in pool_ops.POOLINGS:
            inner = ParameterFreePool(pooling)
        else:
            raise KeyError(pooling)
        return Rpool(inner, nn.Linear(dim, dim))
    if pooling == "gem":
        return GeM(gem_p_init)
    if pooling == "gemmp":
        return GeM(gem_p_init, dim=dim)
    if pooling in ("mac", "spoc", "rmac"):
        return ParameterFreePool(pooling)
    if pooling == "GeometricMedianWeiszfeld":
        pp = dict(pooling_params or {})
        return GeometricMedianPool(pp.get("iterations", 3),
                                   pp.get("intermediate_gradients", False))
    if pooling == "HordeCascadedKOrder":
        # in the reference's POOLINGS registry, but its forward returns a
        # list of embeddings; it is a regularizer (models/extra_layers.py)
        raise NotImplementedError(
            "HordeCascadedKOrder is a regularizer, not a pooling override")
    raise KeyError(pooling)


class GemRetrievalNet(nn.Module):

    def __init__(self, architecture="vgg16", pooling="gem",
                 local_whitening=False, whitening=False, regional=False,
                 gem_p_init=3.0, pooling_params=None):
        super().__init__()
        self.architecture = architecture
        self.pooling = pooling
        self.regional = bool(regional)
        self.features, dim = make_features(architecture)
        self.dim = dim
        self.lwhiten = nn.Linear(dim, dim) if local_whitening else None
        self.pool = make_pool(pooling, dim, gem_p_init, self.regional,
                              pooling_params)
        self.whiten = nn.Linear(dim, dim) if whitening else None

    def _features(self, x, mask):
        """(N, H, W, C) features and their mask (None without one)."""
        # the NHWC input viewed as NCHW is channels-last in memory, which
        # is the layout cuDNN's fastest convolutions take
        feat_mask = None
        if mask is None:
            o = self.features(x.permute(0, 3, 1, 2))
        else:
            o, feat_mask = self.features(x.permute(0, 3, 1, 2), mask=mask)
        return o.permute(0, 2, 3, 1), feat_mask

    def forward(self, x, mask=None):
        """x: (N, H, W, 3) -> (N, D) L2-normalized descriptors. `mask`
        (N, H, W) marks each image's valid top-left rectangle in a padded
        bucket: the features carry it exactly and GeM pools over it."""
        o, feat_mask = self._features(x, mask)
        if self.lwhiten is not None:
            o = self.lwhiten(o)
        o = l2n(self.pool(o, mask=feat_mask))
        if self.whiten is not None:
            o = l2n(self.whiten(o))
        return o

    @property
    def meta(self):
        return {
            "architecture": self.architecture,
            "pooling": self.pooling,
            "local_whitening": self.lwhiten is not None,
            "regional": self.regional,
            "whitening": self.whiten is not None,
            "in_channels": 3,
            "out_channels": self.dim,
            "mean": [0.485, 0.456, 0.406],
            "std": [0.229, 0.224, 0.225],
        }


class GemRetrievalNetPreprocessing(GemRetrievalNet):
    """cirnet with a learnable preprocessing layer before the backbone
    (CirRetrievalNetPreprocessing, cirnet.py:70-104): the edge filter
    `preprocessing`, then the whole net, its whitening heads and regional
    pooling included."""

    def __init__(self, architecture="vgg16", pooling="gem",
                 preprocessing="edgefilter", preprocessing_params=None,
                 local_whitening=False, whitening=False, regional=False,
                 gem_p_init=3.0):
        if preprocessing != "edgefilter":
            raise ValueError("preprocessing %r" % preprocessing)
        super().__init__(architecture, pooling, local_whitening, whitening,
                         regional, gem_p_init)
        self.preprocessing = EdgeFilter(**(preprocessing_params or {}))

    def forward(self, x, mask=None):
        return super().forward(self.preprocessing(x), mask=mask)


class GemRetrievalNetAttention(GemRetrievalNet):
    """cirnet with spatial attention before the pooling
    (CirRetrievalNetAttention, cirnet.py:109-137): the features times
    their attention map (`ATTENTIONS`), pooled by gem, mac, spoc (each over
    a mask too) or rmac, L2-normalized."""

    def __init__(self, architecture="vgg16", pooling="gem",
                 attention="l2norm", normalize_max=True, gem_p_init=3.0):
        if pooling not in ("gem", "mac", "spoc", "rmac"):
            raise KeyError(pooling)
        super().__init__(architecture, pooling, gem_p_init=gem_p_init)
        self.attention = attention
        self.normalize_max = bool(normalize_max)

    def forward(self, x, mask=None):
        o, feat_mask = self._features(x, mask)
        o = o * ATTENTIONS[self.attention](o, normalize_max=self.normalize_max)
        return l2n(self.pool(o, mask=feat_mask))
