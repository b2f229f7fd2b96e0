"""The ResNet image-to-image generator (counterpart of
gandtr_tpu/models/generators.py), NHWC in and out.

Module names are the reference's torch names (`model.<i>`,
`model.<i>.conv_block.<j>`, p2p_networks.py:239-378), so a reference `.pth`
loads with `load_state_dict(strict=True)`. Activations stay channels-last
(NHWC-contiguous), so each residual block hands K3 its input with no copy.

An eligible residual block (ops/resblock.py::eligible: inference, bf16,
reflect padding, instance norm, bias) runs as one fused op, K3 on the card;
any other runs its layers one by one. In `.train()` with batch norm (the
HED^N-GAN generator) every block runs layer by layer in float32, each
BatchNorm on its batch's statistics, and autograd records the forward.

Masked mode (`forward(x, mask=...)`, the padded-bucket form of
gandtr_tpu/models/generators.py:145-286): each image is the valid top-left
rectangle of a zero-padded bucket, and the forward equals the exact-shape
forward on it. Reflect padding reflects at each image's own boundary
(maskprop.masked_reflect_pad), instance norm averages over the valid region
(maskprop.masked_instance_norm), a frozen BatchNorm or the last conv is
followed by re-zeroing the band; sizes follow torch's floor rule for the
stride-2 convs and x2 for the transposed convs; the call returns
`(y, out_mask)`. K3 is not used there (it has no masked form), and a
training-mode BatchNorm is refused.

Feature taps (`forward(x, layers=..., encode_only=...)`, CUT's PatchNCE,
p2p_networks.py:318-337): `layers` are indices into `model` (the torch
Sequential's); the forward returns `(y, feats)`, or with `encode_only`
only `feats`, stopping after the last tap. The reference's ReLUs are in
place, so a tap whose next module is a ReLU is seen ReLU'd, and is stored
so here; the tap at which `encode_only` returns is stored before that
ReLU, since the reference returns before running it.

Blur-pool sampling (`no_antialias` / `no_antialias_up` false, upstream
CUT's default): each stride-2 conv becomes a stride-1 conv, norm, ReLU and
`BlurDownsample`, each transposed conv a `BlurUpsample`, conv, norm and
ReLU; the blur steps are modules of `model`, so CUT's `nce_layers` count
them as the reference's do. Masked mode refuses it, as the JAX package
does.

`ResnetEncoder` / `ResnetDecoder` are the two halves of the generator
(p2p_networks.py:341-472): the encoder's head, two stride-2 convs and
blocks, the decoder's blocks, two transposed convs and tail, each a
`model` Sequential. Their blocks are `ResnetBlock`s, so in bf16 inference
each launches K3.

`UnetGenerator` is pix2pix's U-Net (p2p_networks.py:133-239), with its
nested torch names: the outermost block is `model`, each block's layers
are `model.<j>` and its inner block is `model.1` (outermost) or `model.3`
(`model.model.1.model.3.model.1.weight` is the third block's down conv).
Dropout (`use_dropout`) draws from the net's own CPU `torch.Generator`,
`generator`, seeded 0.
"""
import torch
from torch import nn

from gandtr_tpu_torch.models.layers import (BatchNorm, BlurDownsample,
                                            BlurUpsample, Conv, ConvTranspose,
                                            Dropout, InstanceNorm, Pad,
                                            make_norm, tensor_key)
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
        layout K3 reads; remade only when a weight changes. Under
        `torch.export` the weights are traced values with no storage, so
        the exported program makes the layout itself on each call."""
        def hwio():
            return tuple(c.weight.detach().permute(2, 3, 1, 0)
                         .to(torch.bfloat16).contiguous() for c in (c1, c2))
        if torch.compiler.is_exporting():
            return hwio()
        key = tuple(tensor_key(c.weight) for c in (c1, c2))
        if self._hwio is None or self._hwio[0] != key:
            self._hwio = (key, hwio())
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
        norm, use_bias = make_norm(norm_type)
        m = _resnet_head(input_nc, ngf, norm, use_bias, blur=not no_antialias)
        m += [ResnetBlock(ngf * 4, padding_type, norm_type, use_dropout,
                          use_bias) for _ in range(n_blocks)]
        m += _resnet_tail(ngf, output_nc, norm, use_bias,
                          blur=not no_antialias_up)
        self.model = nn.Sequential(*m)
        self.norm_type = norm_type
        self.blur = not (no_antialias and no_antialias_up)
        self.meta = {"in_channels": input_nc, "out_channels": output_nc}

    def forward(self, x, mask=None, layers=(), encode_only=False):
        """x: (N, H, W, input_nc). With `mask` (N, H, W), the masked mode:
        returns (y, out_mask) with the output's valid rectangles. With
        `layers`, the feature taps (the module docstring)."""
        if layers:
            if mask is not None:
                raise NotImplementedError("feature taps in masked mode")
            return self._taps(x, list(layers), encode_only)
        if mask is None:
            return self.model(x)
        if self.blur:
            raise NotImplementedError(
                "masked generator requires no_antialias blur-pool-free form")
        if self.training and self.norm_type == "batch":
            raise NotImplementedError(
                "masked generator requires frozen (eval-mode) BN")
        ms = MaskState.maybe(mask)
        y, ms = _masked_layers(self.model, ms.apply(x), ms)
        return y, ms.mask(y.shape[1], y.shape[2], y.dtype)

    def _taps(self, x, layers, encode_only):
        mods = list(self.model)
        feats, h = [], x
        for i, module in enumerate(mods):
            h = module(h)
            last = encode_only and i == layers[-1]
            if i in layers:
                relu_next = i + 1 < len(mods) and isinstance(mods[i + 1],
                                                             nn.ReLU)
                feats.append(torch.relu(h) if relu_next and not last else h)
            if last:
                return feats
        return h, feats

    @staticmethod
    def output_hw(h, w):
        """Two stride-2 convs down, two transposed convs up."""
        return 4 * -(-h // 4), 4 * -(-w // 4)


def _resnet_head(input_nc, ngf, norm, use_bias, blur=False):
    """pad, 7x7 conv, norm, ReLU, then two downsampling steps: a stride-2
    conv, norm, ReLU, or (`blur`) a stride-1 conv, norm, ReLU and a
    BlurDownsample."""
    m = [Pad(3, "reflect"), Conv(input_nc, ngf, 7, use_bias=use_bias),
         norm(ngf), nn.ReLU()]
    for i in range(2):
        c = ngf * 2 ** i
        m += [Conv(c, 2 * c, 3, stride=1 if blur else 2, padding=1,
                   use_bias=use_bias), norm(2 * c), nn.ReLU()]
        if blur:
            m.append(BlurDownsample(2 * c))
    return m


def _resnet_tail(ngf, output_nc, norm, use_bias, blur=False):
    """Two upsampling steps: a stride-2 transposed conv, norm, ReLU, or
    (`blur`) a BlurUpsample, a stride-1 conv, norm, ReLU; then pad, 7x7
    conv, tanh."""
    m = []
    for i in range(2):
        c = ngf * 2 ** (2 - i)
        if blur:
            m += [BlurUpsample(c), Conv(c, c // 2, 3, stride=1, padding=1,
                                        use_bias=use_bias)]
        else:
            m.append(ConvTranspose(c, c // 2, 3, stride=2, padding=1,
                                   output_padding=1, use_bias=use_bias))
        m += [norm(c // 2), nn.ReLU()]
    return m + [Pad(3, "reflect"), Conv(ngf, output_nc, 7), nn.Tanh()]


class ResnetEncoder(nn.Module):
    """The downsampling half and `n_blocks` blocks (p2p_networks.py:
    402-472): (N, H, W, input_nc) -> (N, ceil(H/4), ceil(W/4), 4 ngf).
    `no_antialias` is taken and unused, as in the JAX package."""

    def __init__(self, input_nc=3, output_nc=3, ngf=64, norm_type="instance",
                 use_dropout=False, n_blocks=6, padding_type="reflect",
                 no_antialias=True):
        super().__init__()
        norm, use_bias = make_norm(norm_type)
        self.model = nn.Sequential(*_resnet_head(input_nc, ngf, norm,
                                                 use_bias), *[
            ResnetBlock(ngf * 4, padding_type, norm_type, use_dropout,
                        use_bias) for _ in range(n_blocks)])
        self.meta = {"in_channels": input_nc, "out_channels": ngf * 4}

    def forward(self, x):
        return self.model(x)


class ResnetDecoder(nn.Module):
    """`n_blocks` blocks and the upsampling half (p2p_networks.py:341-398):
    (N, h, w, 4 ngf) -> (N, 4h, 4w, output_nc) in (-1, 1)."""

    def __init__(self, input_nc=3, output_nc=3, ngf=64, norm_type="instance",
                 use_dropout=False, n_blocks=6, padding_type="reflect",
                 no_antialias=True):
        super().__init__()
        norm, use_bias = make_norm(norm_type)
        self.model = nn.Sequential(*[
            ResnetBlock(ngf * 4, padding_type, norm_type, use_dropout,
                        use_bias) for _ in range(n_blocks)],
            *_resnet_tail(ngf, output_nc, norm, use_bias))
        self.meta = {"in_channels": ngf * 4, "out_channels": output_nc}

    def forward(self, x):
        return self.model(x)


class UnetSkipBlock(nn.Module):
    """pix2pix's UnetSkipConnectionBlock (p2p_networks.py:168-239): down
    (LeakyReLU 0.2, 4x4 stride-2 conv, norm), the inner block, up (ReLU,
    4x4 stride-2 transposed conv, norm, dropout), and the block's input
    concatenated before its output on the channels; the outermost block
    ends in tanh and concatenates nothing. The skip is the input as the
    block received it (the JAX package's form)."""

    def __init__(self, outer_nc, inner_nc, input_nc=None, submodule=None,
                 outermost=False, innermost=False, norm_type="batch",
                 use_dropout=False, generator=None):
        super().__init__()
        norm, use_bias = make_norm(norm_type)
        input_nc = outer_nc if input_nc is None else input_nc
        down = Conv(input_nc, inner_nc, 4, stride=2, padding=1,
                    use_bias=use_bias)
        if outermost:
            m = [down, submodule, nn.ReLU(),
                 ConvTranspose(inner_nc * 2, outer_nc, 4, stride=2,
                               padding=1, output_padding=0), nn.Tanh()]
        elif innermost:
            m = [nn.LeakyReLU(0.2), down, nn.ReLU(),
                 ConvTranspose(inner_nc, outer_nc, 4, stride=2, padding=1,
                               output_padding=0, use_bias=use_bias),
                 norm(outer_nc)]
        else:
            m = [nn.LeakyReLU(0.2), down, norm(inner_nc), submodule,
                 nn.ReLU(), ConvTranspose(inner_nc * 2, outer_nc, 4,
                                          stride=2, padding=1,
                                          output_padding=0,
                                          use_bias=use_bias),
                 norm(outer_nc)]
            if use_dropout:
                m.append(Dropout(0.5, generator))
        self.outermost = outermost
        self.model = nn.Sequential(*m)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], -1)


class UnetGenerator(nn.Module):
    """pix2pix's U-Net generator (p2p_networks.py:133-165), `num_downs`
    stride-2 levels: (N, H, W, input_nc) -> (N, H, W, output_nc) in (-1, 1)
    for H and W divisible by 2**num_downs (`unet_256`: num_downs 8)."""

    def __init__(self, input_nc=3, output_nc=3, num_downs=8, ngf=64,
                 norm_type="batch", use_dropout=False):
        super().__init__()
        self.generator = torch.Generator().manual_seed(0)
        kw = {"norm_type": norm_type, "generator": self.generator}
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True, **kw)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, submodule=block,
                                  use_dropout=use_dropout, **kw)
        for outer in (4, 2, 1):
            block = UnetSkipBlock(ngf * outer, ngf * outer * 2,
                                  submodule=block, **kw)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc=input_nc,
                                   submodule=block, outermost=True, **kw)
        self.meta = {"in_channels": input_nc, "out_channels": output_nc}

    def forward(self, x):
        return self.model(x)
