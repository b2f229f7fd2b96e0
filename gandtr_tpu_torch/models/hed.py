"""The HED edge detector (counterpart of gandtr_tpu/models/hed.py; the
reference's HedInterpolation, hed.py:20-87), NHWC in and out.

Five VGG16 blocks; after each, a 1x1 score head resized bilinearly to the
input size; a 1x1 fusion of the five maps; a sigmoid unless `no_sigmoid`
(the pre-sigmoid map the HED^N-GAN student is distilled on). Module names
are the reference's torch names: `vgg<b>` Sequentials (block 1 is [conv,
relu, conv, relu], the others start with their max-pool), `score<b>`
convs and the `fusion` Sequential, so the published
`hed_sniklaus_github.pth` loads with `load_state_dict(strict=True)`, and
the JAX package's `hed_key_map` names each of its parameters
(utils/weights.py). `width_mult` scales the VGG widths (at least 4
channels), the JAX package's knob for small tests; 1.0 is the published
net.
"""
import torch
import torch.nn.functional as F
from torch import nn

from gandtr_tpu_torch.models.layers import Conv
from gandtr_tpu_torch.ops.resize import bilinear_resize

_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
           (512, 512, 512))


class MaxPool(nn.Module):
    """2x2 max-pool with stride 2 (floor), NHWC."""

    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class HedInterpolation(nn.Module):
    meta = {"in_channels": 3, "out_channels": 1}

    def __init__(self, width_mult=1.0):
        super().__init__()
        self.width_mult = float(width_mult)
        c = 3
        for b, widths in enumerate(_BLOCKS, start=1):
            layers = [] if b == 1 else [MaxPool()]
            for w in widths:
                w = max(int(w * self.width_mult), 4)
                layers += [Conv(c, w, 3, padding=1), nn.ReLU()]
                c = w
            setattr(self, "vgg%d" % b, nn.Sequential(*layers))
            setattr(self, "score%d" % b, Conv(c, 1, 1))
        self.fusion = nn.Sequential(Conv(len(_BLOCKS), 1, 1))

    def forward(self, x, no_sigmoid=False):
        H, W = x.shape[1], x.shape[2]
        h, scores = x, []
        for b in range(1, len(_BLOCKS) + 1):
            h = getattr(self, "vgg%d" % b)(h)
            scores.append(bilinear_resize(getattr(self, "score%d" % b)(h),
                                          H, W))
        fused = self.fusion(torch.cat(scores, dim=-1))
        return fused if no_sigmoid else torch.sigmoid(fused)
