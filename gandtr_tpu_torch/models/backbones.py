"""CNN feature extractors for descriptor networks (counterpart of
gandtr_tpu/models/backbones.py).

`VGG16Features` is torchvision's `vgg16.features` without its last max-pool,
as the reference's init_network slices it, with torchvision's module indices
(`features.<i>`) so a cirtorch `.pth` state dict loads as it is. It works in
NCHW; the NHWC public layout is handled by the retrieval net around it.

Precision: in float32 every conv is cuDNN float32 (TF32 off, device.py), as
the served descriptor path runs. When the net computes in bf16 (its input is
bf16, e.g. under `WrappedNet.compute_dtype`), `features.2` (conv1_2, 64->64)
and `features.7` (conv2_2, 128->128) with their ReLUs run as one
`ops/vggconv.Conv3x3Same` each: K2 on the card, its backward PyTorch convs.
`features.0` and `features.5` (3->64, 64->128) are not eligible and stay
`nn.Conv2d`, as do the 256- and 512-channel layers.

Padded buckets: with `mask` (N, H, W), the inputs are zero-padded top-left
rectangles and the valid region is carried layer by layer
(ops/maskprop.py): the band is re-zeroed after every conv + ReLU, except
before a pool (the masked max pool masks the band itself), so the valid
features equal the exact-shape forward. The call then returns `(features,
feat_mask)` with the pooled valid rectangle as an (N, h, w) mask.

`ResNetFeatures` is torchvision's resnet50/101/152 without avgpool and fc,
as init_network slices it: `features.0` conv1, `.1` bn1, `.2` relu, `.3`
maxpool, `.4`-`.7` layer1-4 of `Bottleneck`s (conv1..3, bn1..3,
downsample.0/.1, the stride on conv2), so a cirtorch ResNet `.pth` loads as
it is. Its BatchNorms are frozen (`FrozenBatchNorm`): the reference keeps
the descriptor net's BN in eval mode while fine-tuning (cirnet.py:36-45),
the affine weight and bias train. Under a bf16 compute dtype the float32
running statistics promote the output of `bn1` to float32, and every later
conv computes in float32 (`layers.Conv`), as in the JAX package.
In the masked mode it re-zeroes the band where the JAX net does: after the
first ReLU, before each block's 3x3 conv (not after the residual: 1x1
convs do not mix positions) and once at the end.
"""
import torch
from torch import nn

from gandtr_tpu_torch.models.layers import Conv, FrozenBatchNorm
from gandtr_tpu_torch.ops import maskprop, vggconv

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)  # last maxpool dropped

OUTPUT_DIM = {"vgg16": 512, "resnet50": 2048, "resnet101": 2048,
              "resnet152": 2048}
RESNET_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                 "resnet152": (3, 8, 36, 3)}


class VGG16Features(nn.Sequential):
    """Conv3x3(pad 1)+ReLU stacks with 4 max-pools: indices 0..29 as in
    torchvision. (N, 3, H, W) -> (N, 512, H/16, W/16)."""

    def __init__(self):
        layers, cin = [], 3
        for item in VGG16_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
            else:
                layers += [nn.Conv2d(cin, item, kernel_size=3, padding=1),
                           nn.ReLU(inplace=True)]
                cin = item
        super().__init__(*layers)

    def forward(self, x, mask=None):
        """x: (N, 3, H, W) (an NHWC tensor seen as NCHW). Returns the
        features, and with `mask` also their valid mask (N, h, w)."""
        ms = maskprop.MaskState.maybe(mask)
        layers = list(self)
        h = x.permute(0, 2, 3, 1)            # NHWC view, as maskprop takes
        h = ms.apply(h)
        i = 0
        while i < len(layers):
            layer = layers[i]
            if isinstance(layer, nn.MaxPool2d):
                h, ms = maskprop.masked_max_pool(h, ms, 2, 2)
                i += 1
                continue
            if vggconv.eligible(tuple(h.shape), h.dtype, layer.in_channels,
                                layer.out_channels, layer.kernel_size[0],
                                layer.stride[0], layer.dilation[0],
                                layer.padding[0]):
                w = layer.weight.permute(2, 3, 1, 0)   # OIHW -> HWIO
                h = vggconv.Conv3x3Same.apply(h, w, layer.bias, True,
                                              h.dtype)
            else:
                h = torch.relu_(layer(h.permute(0, 3, 1, 2))).permute(
                    0, 2, 3, 1)
            i += 2                            # the conv and its ReLU
            if i == len(layers) or not isinstance(layers[i], nn.MaxPool2d):
                h = ms.apply(h)
        out = h.permute(0, 3, 1, 2)
        if mask is None:
            return out
        return out, ms.mask(h.shape[1], h.shape[2], h.dtype)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck: 1x1 reduce, 3x3 (stride), 1x1 expand, the
    identity or a strided 1x1 + BN downsample. NHWC in and out."""

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 1, use_bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=1,
                          use_bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, use_bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            Conv(inplanes, planes * 4, 1, stride=stride, use_bias=False),
            FrozenBatchNorm(planes * 4)) if downsample else None
        self.stride = stride

    def forward(self, x, ms):
        """(out, the valid rectangle after the block)."""
        h = torch.relu(self.bn1(self.conv1(x)))
        # the BN shift made the band nonzero: re-zero before the 3x3 conv
        h = self.conv2(ms.apply(h))
        h = torch.relu(self.bn2(h))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity), ms.downsample(3, self.stride, 1)


class ResNetFeatures(nn.Sequential):
    """conv1 -> bn1 -> relu -> maxpool -> layer1..4. (N, 3, H, W) ->
    (N, 2048, H/32, W/32)."""

    def __init__(self, arch="resnet101"):
        layers, inplanes = [], 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                             RESNET_LAYERS[arch])):
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(
                    inplanes, planes, stride=2 if (li and not bi) else 1,
                    downsample=bi == 0))
                inplanes = planes * 4
            layers.append(nn.Sequential(*blocks))
        super().__init__(Conv(3, 64, 7, stride=2, padding=3, use_bias=False),
                         FrozenBatchNorm(64), nn.ReLU(inplace=True),
                         nn.MaxPool2d(kernel_size=3, stride=2, padding=1),
                         *layers)
        self.arch = arch

    def forward(self, x, mask=None):
        """x: (N, 3, H, W) (an NHWC tensor seen as NCHW). Returns the
        features, and with `mask` also their valid mask (N, h, w)."""
        ms = maskprop.MaskState.maybe(mask)
        h = ms.apply(x.permute(0, 2, 3, 1))
        h = self[1](self[0](h))
        ms = ms.downsample(7, 2, 3)
        h = ms.apply(torch.relu(h))
        h, ms = maskprop.masked_max_pool(h, ms, 3, 2, 1)
        for layer in list(self)[4:]:
            for block in layer:
                h, ms = block(h, ms)
        if mask is None:
            return h.permute(0, 3, 1, 2)
        # the blocks leave finite values in the band; re-zero it once
        h = ms.apply(h)
        return h.permute(0, 3, 1, 2), ms.mask(h.shape[1], h.shape[2],
                                              h.dtype)


def make_features(architecture):
    """(features module, output channels) for a backbone name: the
    `vgg16*` and `resnet*` prefixes, as the JAX package matches them."""
    if architecture.startswith("vgg16"):
        return VGG16Features(), OUTPUT_DIM["vgg16"]
    if architecture.startswith("resnet"):
        return ResNetFeatures(architecture), OUTPUT_DIM[architecture]
    raise ValueError("Unsupported architecture: %s" % architecture)
