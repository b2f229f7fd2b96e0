"""CNN feature extractors for descriptor networks (counterpart of
gandtr_tpu/models/backbones.py).

`VGG16Features` is torchvision's `vgg16.features` without its last max-pool,
as the reference's init_network slices it, with torchvision's module indices
(`features.<i>`) so a cirtorch `.pth` state dict loads as it is. It works in
NCHW; the NHWC public layout is handled by the retrieval net around it.
"""
from torch import nn

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


def make_features(architecture):
    """(features module, output channels) for a backbone name."""
    if architecture == "vgg16":
        return VGG16Features(), OUTPUT_DIM["vgg16"]
    raise NotImplementedError("backbone %r is not ported yet" % architecture)
