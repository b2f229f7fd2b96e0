"""Building-block layers of the generators (counterpart of
gandtr_tpu/models/layers.py), NHWC in and out.

Each parametrised layer subclasses its torch module, so its parameters keep
torch's names and layouts (`weight` OIHW for a conv, IOHW for a transposed
conv) and a reference `.pth` loads as it is. The JAX package's
`ops/fastconv.py` rewrites are TPU-MXU reformulations of the same convs and
map to plain `F.conv2d` here.

dtype rules follow jnp's: a conv computes in promote(x, weight), so a bf16
activation after a float32 BatchNorm stays float32 through every later
conv, as in the JAX package (layers.py:57-59); a transposed conv computes in
the input's dtype; biases are added after the conv, in its dtype.
"""
import torch
import torch.nn.functional as F
from torch import nn

from gandtr_tpu_torch.ops.norm import batch_norm_inference, instance_norm

_PAD_MODES = {"zero": "constant", "constant": "constant",
              "reflect": "reflect", "refl": "reflect",
              "replicate": "replicate", "repl": "replicate"}


def tensor_key(t):
    """What identifies a tensor's current values, for caches made from it:
    its storage and version (an inference tensor has no version counter)."""
    return t.data_ptr(), (-1 if t.is_inference() else t._version)


def pad2d(x, pad, mode="zero"):
    """Pad both spatial dims of an NHWC tensor by `pad` on each side.
    Returns an NHWC-contiguous tensor."""
    if mode not in _PAD_MODES:
        raise NotImplementedError("pad mode %s" % mode)
    y = F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode=_PAD_MODES[mode])
    return y.permute(0, 2, 3, 1).contiguous()


class Pad(nn.Module):
    """The reference's ReflectionPad2d / ReplicationPad2d step, NHWC."""

    def __init__(self, pad, mode="reflect"):
        super().__init__()
        self.pad, self.mode = pad, mode

    def forward(self, x):
        return pad2d(x, self.pad, self.mode)


class Conv(nn.Conv2d):
    """Conv2d with torch-style integer padding (`pad_mode` zero, reflect or
    replicate); NHWC in and out."""

    def __init__(self, in_channels, features, kernel_size=3, stride=1,
                 padding=0, use_bias=True, pad_mode="zero"):
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         bias=use_bias)
        self.pad, self.pad_mode = padding, pad_mode

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt)
        zero = _PAD_MODES.get(self.pad_mode) == "constant"
        if self.pad and not zero:
            x = pad2d(x, self.pad, self.pad_mode)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), None,
                     self.stride, self.pad if zero else 0)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ConvTranspose(nn.ConvTranspose2d):
    """torch ConvTranspose2d(k, s, p, output_padding); NHWC in and out."""

    def __init__(self, in_channels, features, kernel_size=3, stride=2,
                 padding=1, output_padding=1, use_bias=True):
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         padding=padding, output_padding=output_padding,
                         bias=use_bias)

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                               self.weight.to(x.dtype), None, self.stride,
                               self.padding, self.output_padding)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class InstanceNorm(nn.Module):
    """torch InstanceNorm2d(affine=False): no parameters."""

    def __init__(self, epsilon=1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x):
        return instance_norm(x, eps=self.epsilon)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d in its frozen eval form only, over the last axis. Its
    running statistics are buffers, so a bf16 copy of the net keeps them
    float32 (and promotes its output to float32, as in the JAX package).
    The training form comes with GAN training."""

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNorm runs in eval mode only (call .eval())")
        return batch_norm_inference(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, self.eps)


def make_norm(norm_type):
    """(ctor(channels) -> module, use_bias_for_convs), as get_norm_layer
    (p2p_networks.py:23-35)."""
    if norm_type == "instance":
        return lambda c: InstanceNorm(), True
    if norm_type == "batch":
        return BatchNorm, False
    if norm_type == "none":
        return lambda c: nn.Identity(), True
    raise NotImplementedError("normalization layer [%s] is not found"
                              % norm_type)
