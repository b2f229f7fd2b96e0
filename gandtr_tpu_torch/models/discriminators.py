"""PatchGAN discriminators (counterpart of
gandtr_tpu/models/discriminators.py; the reference's NLayerDiscriminator
and PatchDiscriminator, p2p_networks.py:559-607), NHWC in and out.

Module names are the reference's torch names (`model.<i>`, and `d.model.<i>`
inside the patch discriminator), so a reference `.pth` loads with
`load_state_dict(strict=True)`. With `no_antialias` false (blur-pool, the
default of upstream CUT) each stride-2 conv is a stride-1 conv followed by
its norm, LeakyReLU and a `BlurDownsample`, which is a module of `model`.
"""
from torch import nn

from gandtr_tpu_torch.models.layers import BlurDownsample, Conv, make_norm


def _lrelu():
    return nn.LeakyReLU(0.2)


class NLayerDiscriminator(nn.Module):
    """conv(s2)-lrelu, (n_layers - 1) x [conv(s2)-norm-lrelu],
    conv(s1)-norm-lrelu, conv(s1) to one channel: (N, H, W, input_nc) ->
    (N, h, w, 1) patch scores. Blur-pool: conv(s1)-lrelu-blur and
    conv(s1)-norm-lrelu-blur in place of the stride-2 steps."""

    def __init__(self, input_nc=3, ndf=64, n_layers=3, kw=4,
                 norm_type="batch", no_antialias=True):
        super().__init__()
        norm, use_bias = make_norm(norm_type)
        s = 2 if no_antialias else 1
        blur = [] if no_antialias else [BlurDownsample(ndf)]
        m = [Conv(input_nc, ndf, kw, stride=s, padding=1), _lrelu()] + blur
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            m += [Conv(ndf * prev, ndf * mult, kw, stride=s, padding=1,
                       use_bias=use_bias), norm(ndf * mult), _lrelu()]
            if not no_antialias:
                m.append(BlurDownsample(ndf * mult))
        prev, mult = mult, min(2 ** n_layers, 8)
        m += [Conv(ndf * prev, ndf * mult, kw, stride=1, padding=1,
                   use_bias=use_bias), norm(ndf * mult), _lrelu(),
              Conv(ndf * mult, 1, kw, stride=1, padding=1)]
        self.model = nn.Sequential(*m)
        self.meta = {"in_channels": input_nc, "out_channels": 1}

    def forward(self, x):
        return self.model(x)


class PatchDiscriminator(nn.Module):
    """The image cut into 16x16 tiles, each scored on its own by a 2-layer
    NLayerDiscriminator: (N, H, W, C) -> (N * H/16 * W/16, h, w, 1)."""

    SIZE = 16

    def __init__(self, input_nc=3, ndf=64, n_layers=2, norm_type="batch",
                 no_antialias=True):
        super().__init__()
        self.d = NLayerDiscriminator(input_nc, ndf, n_layers, 4, norm_type,
                                     no_antialias)
        self.meta = dict(self.d.meta)

    def forward(self, x):
        B, H, W, C = x.shape
        s = self.SIZE
        Y, X = H // s, W // s
        h = x.reshape(B, Y, s, X, s, C).permute(0, 1, 3, 2, 4, 5)
        return self.d(h.reshape(B * Y * X, s, s, C))
