"""The ResNet image-to-image generator (counterpart of
gandtr_tpu/models/generators.py), NHWC in and out.

Module names are the reference's torch names (`model.<i>`,
`model.<i>.conv_block.<j>`, p2p_networks.py:239-378), so a reference `.pth`
loads with `load_state_dict(strict=True)`. Activations stay channels-last
(NHWC-contiguous), so each residual block hands K3 its input with no copy.

An eligible residual block (ops/resblock.py::eligible: inference, bf16,
reflect padding, instance norm, bias) runs as one fused op, K3 on the card;
any other runs its layers one by one.

Masked mode (`forward(x, mask=...)`, the padded-bucket form of
gandtr_tpu/models/generators.py:145-286): each image is the valid top-left
rectangle of a zero-padded bucket, and the forward equals the exact-shape
forward on it. Reflect padding reflects at each image's own boundary
(maskprop.masked_reflect_pad), instance norm averages over the valid region
(maskprop.masked_instance_norm), a frozen BatchNorm or the last conv is
followed by re-zeroing the band; sizes follow torch's floor rule for the
stride-2 convs and x2 for the transposed convs; the call returns
`(y, out_mask)`. K3 is not used there (it has no masked form), and a
training-mode BatchNorm is refused. Only `no_antialias` sampling is ported:
the feature taps (`layers`, `encode_only`), the blur-pool sampling,
ResnetEncoder / ResnetDecoder and UnetGenerator come later.
"""
import torch
from torch import nn

from gandtr_tpu_torch.models.layers import (BatchNorm, Conv, ConvTranspose,
                                            InstanceNorm, Pad, make_norm,
                                            tensor_key)
from gandtr_tpu_torch.ops import resblock
from gandtr_tpu_torch.ops.maskprop import (MaskState, masked_instance_norm,
                                           masked_reflect_pad)

_NORMS = (InstanceNorm, BatchNorm, nn.Identity)


def _masked_layers(layers, h, ms):
    """Run `layers` (NHWC) on padded-bucket images, carrying the valid
    rectangle `ms`; returns (h, ms)."""
    layers = list(layers)
    for i, layer in enumerate(layers):
        if isinstance(layer, Pad):
            if layer.mode not in ("reflect", "refl"):
                raise NotImplementedError("masked %s padding" % layer.mode)
            h, ms = masked_reflect_pad(h, ms, layer.pad)
        elif isinstance(layer, Conv):
            h = layer(h)
            ms = ms.downsample(layer.kernel_size[0], layer.stride[0],
                               layer.pad)
            if i + 1 == len(layers) or not isinstance(layers[i + 1], _NORMS):
                h = ms.apply(h)  # no norm follows to re-zero the bias band
        elif isinstance(layer, ConvTranspose):
            h, ms = layer(h), ms.upsample(2)
        elif isinstance(layer, InstanceNorm):
            h = masked_instance_norm(h, ms, layer.epsilon)
        elif isinstance(layer, (BatchNorm, nn.Identity)):
            h = ms.apply(layer(h))
        elif isinstance(layer, ResnetBlock):
            h = layer(h, ms=ms)
        else:  # ReLU, Tanh, Dropout: zero stays zero
            h = layer(h)
    return h, ms


class ResnetBlock(nn.Module):
    """pad-conv-norm-relu-[dropout]-pad-conv-norm + skip."""

    def __init__(self, dim, padding_type="reflect", norm_type="instance",
                 use_dropout=False, use_bias=True):
        super().__init__()
        norm, _ = make_norm(norm_type)
        p = 1 if padding_type == "zero" else 0
        layers = []
        for second in (False, True):
            if second and use_dropout:
                layers.append(nn.Dropout(0.5))
            if p == 0:
                layers.append(Pad(1, padding_type))
            layers += [Conv(dim, dim, 3, padding=p, use_bias=use_bias,
                            pad_mode=padding_type), norm(dim)]
            if not second:
                layers.append(nn.ReLU())
        self.conv_block = nn.Sequential(*layers)
        self._convs = [i for i, l in enumerate(layers) if isinstance(l, Conv)]
        self.padding_type, self.norm_type = padding_type, norm_type
        self.use_dropout, self.use_bias = use_dropout, use_bias
        self._hwio = None  # (key, (w1, w2)): K3's weights, made once

    def _fused_weights(self, c1, c2):
        """Both conv weights as bf16 HWIO-contiguous (3, 3, C, C), the
        layout K3 reads; remade only when a weight changes."""
        key = tuple(tensor_key(c.weight) for c in (c1, c2))
        if self._hwio is None or self._hwio[0] != key:
            self._hwio = (key, tuple(
                c.weight.detach().permute(2, 3, 1, 0).to(torch.bfloat16)
                .contiguous() for c in (c1, c2)))
        return self._hwio[1]

    def forward(self, x, ms=None):
        if ms is not None and ms.active:
            h, _ = _masked_layers(self.conv_block, x, ms)
            return x + h
        c1, c2 = (self.conv_block[i] for i in self._convs)
        graph = torch.is_grad_enabled() and (x.requires_grad
                                             or c1.weight.requires_grad)
        if resblock.eligible(
                tuple(x.shape), x.dtype, train=self.training or graph,
                use_dropout=self.use_dropout, padding_type=self.padding_type,
                norm_type=self.norm_type, use_bias=self.use_bias):
            w1, w2 = self._fused_weights(c1, c2)
            return resblock.fused_resblock(x.contiguous(), w1, c1.bias, w2,
                                           c2.bias)
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """9-block ResNet generator (p2p_networks.py:239-337). (N, H, W,
    input_nc) -> (N, 4*ceil(H/4), 4*ceil(W/4), output_nc) in (-1, 1)."""

    def __init__(self, input_nc=3, output_nc=3, ngf=64, norm_type="instance",
                 use_dropout=False, n_blocks=9, padding_type="reflect",
                 no_antialias=True, no_antialias_up=True):
        super().__init__()
        if not (no_antialias and no_antialias_up):
            raise NotImplementedError(
                "the blur-pool (antialiased) sampling is not ported yet")
        norm, use_bias = make_norm(norm_type)
        m = [Pad(3, "reflect"), Conv(input_nc, ngf, 7, use_bias=use_bias),
             norm(ngf), nn.ReLU()]
        for i in range(2):
            c = ngf * 2 ** i
            m += [Conv(c, 2 * c, 3, stride=2, padding=1, use_bias=use_bias),
                  norm(2 * c), nn.ReLU()]
        m += [ResnetBlock(ngf * 4, padding_type, norm_type, use_dropout,
                          use_bias) for _ in range(n_blocks)]
        for i in range(2):
            c = ngf * 2 ** (2 - i)
            m += [ConvTranspose(c, c // 2, 3, stride=2, padding=1,
                                output_padding=1, use_bias=use_bias),
                  norm(c // 2), nn.ReLU()]
        m += [Pad(3, "reflect"), Conv(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*m)
        self.norm_type = norm_type
        self.meta = {"in_channels": input_nc, "out_channels": output_nc}

    def forward(self, x, mask=None):
        """x: (N, H, W, input_nc). With `mask` (N, H, W), the masked mode:
        returns (y, out_mask) with the output's valid rectangles."""
        if mask is None:
            return self.model(x)
        if self.training and self.norm_type == "batch":
            raise NotImplementedError(
                "masked generator requires frozen (eval-mode) BN")
        ms = MaskState.maybe(mask)
        y, ms = _masked_layers(self.model, ms.apply(x), ms)
        return y, ms.mask(y.shape[1], y.shape[2], y.dtype)

    @staticmethod
    def output_hw(h, w):
        """Two stride-2 convs down, two transposed convs up."""
        return 4 * -(-h // 4), 4 * -(-w // 4)
