"""GeM descriptor network (counterpart of gandtr_tpu/models/retrieval.py).

features -> (local whiten) -> pool -> L2N -> (whiten -> L2N), as cirtorch's
ImageRetrievalNet. Module names follow that net (`features.<i>`, `pool.p`,
`lwhiten`, `whiten`), so a reference `.pth` loads with `load_state_dict`.
Input (N, H, W, 3) normalized images, output (N, D) descriptors.
"""
import torch
from torch import nn

from gandtr_tpu_torch.models.backbones import make_features
from gandtr_tpu_torch.ops import pooling as pool_ops
from gandtr_tpu_torch.ops.norm import l2n


class GeM(nn.Module):
    """Generalized-mean pooling with a learnable `p` of shape (1,)."""

    def __init__(self, p=3.0, eps=1e-6):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), float(p)))
        self.eps = eps

    def forward(self, x, mask=None):
        """x: (N, H, W, C) -> (N, C); `mask` (N, H, W) restricts the mean
        to the valid positions."""
        return pool_ops.gem(x, p=self.p, eps=self.eps, mask=mask)


class GemRetrievalNet(nn.Module):

    def __init__(self, architecture="vgg16", pooling="gem",
                 local_whitening=False, whitening=False, gem_p_init=3.0):
        super().__init__()
        self.architecture = architecture
        self.pooling = pooling
        self.features, dim = make_features(architecture)
        self.dim = dim
        self.lwhiten = nn.Linear(dim, dim) if local_whitening else None
        if pooling != "gem":
            raise NotImplementedError("pooling %r is not ported yet" % pooling)
        self.pool = GeM(gem_p_init)
        self.whiten = nn.Linear(dim, dim) if whitening else None

    def forward(self, x, mask=None):
        """x: (N, H, W, 3) -> (N, D) L2-normalized descriptors. `mask`
        (N, H, W) marks each image's valid top-left rectangle in a padded
        bucket: the features carry it exactly and GeM pools over it."""
        # the NHWC input viewed as NCHW is channels-last in memory, which
        # is the layout cuDNN's fastest convolutions take
        feat_mask = None
        if mask is None:
            o = self.features(x.permute(0, 3, 1, 2))
        else:
            o, feat_mask = self.features(x.permute(0, 3, 1, 2), mask=mask)
        o = o.permute(0, 2, 3, 1)
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
            "regional": False,
            "whitening": self.whiten is not None,
            "in_channels": 3,
            "out_channels": self.dim,
            "mean": [0.485, 0.456, 0.406],
            "std": [0.229, 0.224, 0.225],
        }
