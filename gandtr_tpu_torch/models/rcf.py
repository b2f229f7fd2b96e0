"""The RCF edge detector (counterpart of gandtr_tpu/models/rcf.py; the
reference's rcf.py:21-157), NHWC in and out.

A VGG16 trunk of 13 3x3 convs with ReLU; a 2x2 max-pool in ceil mode
before each stage after the first, of stride 2, and of stride 1 before
stage 5, whose convs are dilated by 2. Each conv feeds a 21-channel 1x1
`conv<s>_<c>_down`; a stage's downs are summed into its 1x1
`score_dsn<s>`. Stages 2-5 are upsampled by transposed convs with fixed
bilinear kernels of sizes 4, 8, 16, 16 and strides 2, 4, 8, 8, cropped to
the input at offsets 1, 2, 4, 0 (the reference's); a 1x1 `score_fuse` of
the five maps, then a sigmoid unless `no_sigmoid`.

Module names are the reference's, so a published RCF `.pth` loads with
`load_state_dict(strict=True)`. The bilinear kernels are non-persistent
buffers, built on the CPU and moved with the module (the reference
hardcodes `.cuda()` for them); they are not in the state dict.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gandtr_tpu_torch.models.layers import Conv
from gandtr_tpu_torch.parallel import spatial

_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
           (512, 512, 512))
#: (kernel size, stride, crop offset) of the fixed upsampling of stages 2-5
_UPSAMPLE = ((4, 2, 1), (8, 4, 2), (16, 8, 4), (16, 8, 0))


def bilinear_filter(size):
    """The (size, size) bilinear upsampling kernel (rcf.py:127-140)."""
    factor = (size + 1) // 2
    center = factor - 1 if size % 2 == 1 else factor - 0.5
    og = np.ogrid[:size, :size]
    filt = (1 - abs(og[0] - center) / factor) \
        * (1 - abs(og[1] - center) / factor)
    return torch.from_numpy(filt.astype(np.float32))


def ceil_pool(x, stride):
    """MaxPool2d(2, stride, ceil_mode=True) over an NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, stride,
                        ceil_mode=True).permute(0, 2, 3, 1)


class RCF(nn.Module):
    meta = {"in_channels": 3, "out_channels": 1}

    def __init__(self):
        super().__init__()
        c = 3
        for s, widths in enumerate(_STAGES, start=1):
            d = 2 if s == 5 else 1
            for i, w in enumerate(widths, start=1):
                setattr(self, "conv%d_%d" % (s, i),
                        Conv(c, w, 3, padding=d, dilation=d))
                setattr(self, "conv%d_%d_down" % (s, i), Conv(w, 21, 1))
                c = w
            setattr(self, "score_dsn%d" % s, Conv(21, 1, 1))
        self.score_fuse = Conv(len(_STAGES), 1, 1)
        for size in sorted({k for k, _, _ in _UPSAMPLE}):
            self.register_buffer("deconv%d" % size,
                                 bilinear_filter(size)[None, None],
                                 persistent=False)

    def forward(self, x, no_sigmoid=False):
        spatial.refuse("RCF")
        H, W = x.shape[1], x.shape[2]
        h, scores = x, []
        for s, widths in enumerate(_STAGES, start=1):
            if s > 1:
                h = ceil_pool(h, 1 if s == 5 else 2)
            downs = []
            for i in range(1, len(widths) + 1):
                h = torch.relu(getattr(self, "conv%d_%d" % (s, i))(h))
                downs.append(getattr(self, "conv%d_%d_down" % (s, i))(h))
            scores.append(getattr(self, "score_dsn%d" % s)(sum(downs)))
        outs = [scores[0]]
        for score, (size, stride, off) in zip(scores[1:], _UPSAMPLE):
            k = getattr(self, "deconv%d" % size).to(score.dtype)
            up = F.conv_transpose2d(score.permute(0, 3, 1, 2), k,
                                    stride=stride)
            outs.append(up[:, :, off:off + H, off:off + W]
                        .permute(0, 2, 3, 1))
        fuse = self.score_fuse(torch.cat(outs, dim=-1))
        return fuse if no_sigmoid else torch.sigmoid(fuse)
