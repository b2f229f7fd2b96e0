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
"""
import torch
from torch import nn

from gandtr_tpu_torch.ops import maskprop, vggconv

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)  # last maxpool dropped

OUTPUT_DIM = {"vgg16": 512}


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


def make_features(architecture):
    """(features module, output channels) for a backbone name."""
    if architecture == "vgg16":
        return VGG16Features(), OUTPUT_DIM["vgg16"]
    raise NotImplementedError("backbone %r is not ported yet" % architecture)
