"""The U-Net variants (counterpart of gandtr_tpu/models/unet.py; the
reference's unet.py), NHWC in and out: OrigUNet (double-conv U-Net),
P2pUNet (pix2pix-style), ShallowP2pUNet, OutconvP2pUNet,
OutconvP2pUNetDynamicInterpolate (a resize up in place of the transposed
conv), InconvP2pUNet and AlignedP2pUNet (stride-1 head and tail).

Module names are the JAX package's, its `<name>_<i>` as `<name>.<i>` (a
ModuleList): `skip.0.down.weight`, `down.1.conv1.weight`, `bnd.0.weight`.
They are what the JAX importer's default key map makes of the JAX
variables, so a state_dict of this module loads into the JAX net through
`convert_torch_state` and back through `from_jax_variables`. The nested
blocks of a P2p U-Net are siblings in `skip`, outermost first; each
block's forward takes the next one as an argument.
"""
import torch
from torch import nn

from gandtr_tpu_torch.models.layers import (BatchNorm, Conv, ConvTranspose,
                                            Dropout)
from gandtr_tpu_torch.ops.resize import bilinear_resize, nearest_resize
from gandtr_tpu_torch.parallel import spatial

_lrelu = nn.functional.leaky_relu
_relu = torch.relu


def _p2p_blocks(nested_levels, base=((64, 128), (128, 256), (256, 512),
                                     (512, 512))):
    blocks = list(base[:nested_levels])
    while len(blocks) < nested_levels:
        blocks.append((512, 512))
    return blocks


def _convt(cin, cout, use_bias=True):
    return ConvTranspose(cin, cout, 4, stride=2, padding=1, output_padding=0,
                         use_bias=use_bias)


def _convt_2(cin, cout):
    return ConvTranspose(cin, cout, 2, stride=2, padding=0, output_padding=0)


class _DoubleConv(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, padding=1)
        self.conv2 = Conv(features, features, 3, padding=1)

    def forward(self, x):
        spatial.refuse("the U-Nets")
        return _relu(self.conv2(_relu(self.conv1(x))))


class OrigUNet(nn.Module):
    """The classic U-Net (unet.py:6-45): double-conv blocks, 2x2 max-pool
    down, 2x2 stride-2 transposed conv up, the skip concatenated."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=4,
                 min_channels=64):
        super().__init__()
        ch = [min_channels * 2 ** i for i in range(nested_levels)]
        cin = [in_channels] + ch[:-1]
        self.down = nn.ModuleList(_DoubleConv(a, b) for a, b in zip(cin, ch))
        self.inner = _DoubleConv(ch[-1], ch[-1] * 2)
        self.up = nn.ModuleList(_convt_2(2 * c, c) for c in ch)
        self.upconv = nn.ModuleList(_DoubleConv(2 * c, c) for c in ch)
        self.outconv = Conv(ch[0], out_channels, 1)

    def forward(self, x):
        spatial.refuse("the U-Nets")
        def pool(h):
            return nn.functional.max_pool2d(
                h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

        def block(h, level):
            h1 = self.down[level](h)
            if level == len(self.down) - 1:
                inner = self.inner(pool(h1))
            else:
                inner = block(pool(h1), level + 1)
            up = self.up[level](inner)
            return self.upconv[level](torch.cat([h1, up], -1))

        return self.outconv(block(x, 0))


class _P2pSkip(nn.Module):
    """pix2pix's skip block (unet.py:52-81): down conv, then with an inner
    block (batch norm), LeakyReLU 0.2 and the inner block, else ReLU; the
    transposed conv up, (batch norm), (dropout), ReLU; the input
    concatenated before it. `inner_out` is the inner block's output
    channels (None for the innermost)."""

    def __init__(self, outer, inter, inner_out=None, batchnorm=True,
                 dropout=0.0, use_bias=False, generator=None):
        super().__init__()
        self.down = Conv(outer, inter, 4, stride=2, padding=1,
                         use_bias=use_bias)
        nested = inner_out is not None
        self.bn_down = BatchNorm(inter) if nested and batchnorm else None
        self.up = _convt(inner_out if nested else inter, outer, use_bias)
        self.bn_up = BatchNorm(outer) if batchnorm else None
        self.drop = Dropout(dropout, generator) if dropout else None

    def forward(self, x, nested=None):
        spatial.refuse("the U-Nets")
        h = self.down(x)
        if nested is not None:
            if self.bn_down is not None:
                h = self.bn_down(h)
            h = nested(_lrelu(h, 0.2))
        else:
            h = _relu(h)
        h = self.up(h)
        if self.bn_up is not None:
            h = self.bn_up(h)
        if self.drop is not None:
            h = self.drop(h)
        return torch.cat([x, _relu(h)], -1)


def _skips(blocks, batchnorm, dropouts, use_bias, generator):
    """The skip blocks of `blocks` [(outer, inter)], outermost first."""
    out = []
    for i, (cin, cout) in enumerate(blocks):
        inner_out = 2 * blocks[i + 1][0] if i + 1 < len(blocks) else None
        out.append(_P2pSkip(cin, cout, inner_out, batchnorm, dropouts[i],
                            use_bias, generator))
    return nn.ModuleList(out)


def _run_skips(skips, h):
    def run(i, x):
        if i + 1 == len(skips):
            return skips[i](x)
        return skips[i](x, lambda y: run(i + 1, y))
    return run(0, h)


class P2pUNet(nn.Module):
    """The pix2pix U-Net (unet.py:48-110); its conv_opts carry bias=False,
    and only the deep extra blocks take dropout."""

    def __init__(self, in_channels=3, out_channels=3, dropout=0.0,
                 batchnorm=True, nested_levels=7):
        super().__init__()
        base = [(64, 128), (128, 256), (256, 512), (512, 512)]
        blocks = base[:nested_levels]
        drops = [0.0] * len(blocks)
        blocks += [(512, 512)] * (nested_levels - len(blocks))
        drops += [dropout] * (nested_levels - len(drops))
        self.generator = torch.Generator().manual_seed(0)
        self.skip = _skips(blocks, batchnorm, drops, False, self.generator)
        self.inconv = Conv(in_channels, 64, 4, stride=2, padding=1,
                           use_bias=False)
        self.outconvT = _convt(128, out_channels)

    def forward(self, x):
        spatial.refuse("the U-Nets")
        h = _run_skips(self.skip, _lrelu(self.inconv(x), 0.2))
        return torch.tanh(self.outconvT(h))


class ShallowP2pUNet(nn.Module):
    """The shallow variant with 1x1 refinements (unet.py:113-176)."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=4):
        super().__init__()
        self.blocks = _p2p_blocks(nested_levels,
                                  ((64, 128), (128, 256), (256, 512)))
        b = self.blocks
        self.d = nn.ModuleList(Conv(i, o, 4, stride=2, padding=1)
                               for i, o in b)
        self.d1 = nn.ModuleList(Conv(o, o, 1) for _, o in b)
        self.u = nn.ModuleList(_convt(2 * o if k + 1 < len(b) else o, i)
                               for k, (i, o) in enumerate(b))
        self.u1 = nn.ModuleList(Conv(i, i, 1) for i, _ in b)
        self.inconv = Conv(in_channels, 64, 4, stride=2, padding=1)
        self.inconv1 = Conv(64, 64, 1)
        self.outconvT = _convt(128, 64)
        self.outconv1 = Conv(64, 64, 1)
        self.outconv = Conv(64, out_channels, 1)

    def forward(self, x):
        spatial.refuse("the U-Nets")
        def skip(h, k):
            h1 = _relu(self.d1[k](_relu(self.d[k](h))))
            if k + 1 < len(self.blocks):
                h1 = skip(h1, k + 1)
            h1 = _relu(self.u1[k](_relu(self.u[k](h1))))
            return torch.cat([h, h1], -1)

        h = _relu(self.inconv1(_relu(self.inconv(x))))
        h = _relu(self.outconv1(_relu(self.outconvT(skip(h, 0)))))
        return self.outconv(h)


class OutconvP2pUNet(nn.Module):
    """P2pUNet with a conv head in place of tanh (unet.py:179-213)."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=7,
                 outconv_channels=32, outconv_kernel=3, batchnorm=False,
                 dropout=0.0):
        super().__init__()
        blocks = _p2p_blocks(nested_levels,
                             ((64, 128), (128, 256), (256, 512)))
        self.generator = torch.Generator().manual_seed(0)
        self.skip = _skips(blocks, batchnorm, [dropout] * len(blocks), True,
                           self.generator)
        self.inconv = Conv(in_channels, 64, 4, stride=2, padding=1)
        self.outconvT = _convt(128 if blocks else 64, outconv_channels)
        self.outconv = Conv(outconv_channels, out_channels, outconv_kernel,
                            padding=outconv_kernel // 2)

    def forward(self, x):
        spatial.refuse("the U-Nets")
        h = _lrelu(self.inconv(x), 0.2)
        if len(self.skip):
            h = _run_skips(self.skip, h)
        return self.outconv(_relu(self.outconvT(h)))


class OutconvP2pUNetDynamicInterpolate(nn.Module):
    """Down convs, then a resize back to each level's input size and a
    3x3 conv (unet.py:216-287): any input size."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=7,
                 upsample="bilinear", outconv_channels=32, outconv_kernel=3,
                 batchnorm=False, dropout=0.0):
        super().__init__()
        self.blocks = b = _p2p_blocks(nested_levels,
                                      ((64, 128), (128, 256), (256, 512)))
        self.upsample = upsample
        self.d = nn.ModuleList(Conv(i, o, 4, stride=2, padding=1)
                               for i, o in b)
        self.bnd = nn.ModuleList(BatchNorm(o) for _, o in b) \
            if batchnorm else None
        self.u = nn.ModuleList(Conv(2 * o if k + 1 < len(b) else o, i, 3,
                                    padding=1)
                               for k, (i, o) in enumerate(b))
        self.bnu = nn.ModuleList(BatchNorm(i) for i, _ in b) \
            if batchnorm else None
        self.generator = torch.Generator().manual_seed(0)
        self.drop = Dropout(dropout, self.generator) if dropout else None
        self.inconv = Conv(in_channels, 64, 4, stride=2, padding=1)
        self.up0 = Conv(128, outconv_channels, 3, padding=1)
        self.outconv = Conv(outconv_channels, out_channels, outconv_kernel,
                            padding=outconv_kernel // 2)

    def _resize(self, h, size):
        if self.upsample == "bilinear":
            return bilinear_resize(h, *size)
        return nearest_resize(h, *size)

    def forward(self, x):
        spatial.refuse("the U-Nets")
        def skip(h, k):
            size = h.shape[1:3]
            h1 = self.d[k](h)
            if self.bnd is not None:
                h1 = self.bnd[k](h1)
            h1 = _lrelu(h1, 0.2)
            if k + 1 < len(self.blocks):
                h1 = skip(h1, k + 1)
            h1 = self.u[k](self._resize(h1, size))
            if self.bnu is not None:
                h1 = self.bnu[k](h1)
            if self.drop is not None:
                h1 = self.drop(h1)
            return torch.cat([h, _relu(h1)], -1)

        size = x.shape[1:3]
        h = skip(_lrelu(self.inconv(x), 0.2), 0)
        h = _relu(self.up0(self._resize(h, size)))
        return self.outconv(h)


class InconvP2pUNet(nn.Module):
    """P2pUNet with a 1x1 input adapter (unet.py:290-316)."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=7):
        super().__init__()
        blocks = _p2p_blocks(nested_levels,
                             ((64, 128), (128, 256), (256, 512)))
        self.skip = _skips(blocks, False, [0.0] * len(blocks), True, None)
        self.inconv1x1 = Conv(in_channels, 64, 1)
        self.inconv = Conv(64, 64, 4, stride=2, padding=1)
        self.outconvT = _convt(128, out_channels)

    def forward(self, x):
        spatial.refuse("the U-Nets")
        h = _lrelu(self.inconv(_lrelu(self.inconv1x1(x), 0.2)), 0.2)
        return torch.tanh(self.outconvT(_run_skips(self.skip, h)))


class AlignedP2pUNet(nn.Module):
    """The fully aligned variant: stride-1 3x3 head and tail
    (unet.py:319-349)."""

    def __init__(self, in_channels=3, out_channels=3, nested_levels=7):
        super().__init__()
        blocks = _p2p_blocks(nested_levels,
                             ((64, 128), (128, 256), (256, 512)))
        self.skip = _skips(blocks, False, [0.0] * len(blocks), True, None)
        self.in1 = Conv(in_channels, 64, 3, padding=1)
        self.in2 = Conv(64, 64, 3, padding=1)
        self.out1 = Conv(128, 64, 3, padding=1)
        self.out2 = Conv(64, 64, 3, padding=1)
        self.outconv = Conv(64, out_channels, 3, padding=1)

    def forward(self, x):
        spatial.refuse("the U-Nets")
        h = _relu(self.in2(_relu(self.in1(x))))
        h = _run_skips(self.skip, h)
        h = _relu(self.out2(_relu(self.out1(h))))
        return self.outconv(h)
