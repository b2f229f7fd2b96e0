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


def _reflect_cat(x, pad, dim):
    """Reflect-pad one axis by concatenating flipped slices."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, pad).flip(dim), x,
                      x.narrow(dim, n - 1 - pad, pad).flip(dim)], dim)


def pad2d(x, pad, mode="zero"):
    """Pad both spatial dims of an NHWC tensor by `pad` on each side.
    Returns an NHWC-contiguous tensor.

    A reflect pad is built from flipped slices: its backward then sums a
    border pixel's two gradients in a fixed order, where the CUDA backward
    of `F.pad(mode="reflect")` adds them with atomics, in any order."""
    if mode not in _PAD_MODES:
        raise NotImplementedError("pad mode %s" % mode)
    if _PAD_MODES[mode] == "reflect":
        return _reflect_cat(_reflect_cat(x, pad, 1), pad, 2)
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
    replicate) and dilation; NHWC in and out."""

    def __init__(self, in_channels, features, kernel_size=3, stride=1,
                 padding=0, use_bias=True, pad_mode="zero", dilation=1):
        super().__init__(in_channels, features, kernel_size, stride=stride,
                         dilation=dilation, bias=use_bias)
        self.pad, self.pad_mode = padding, pad_mode

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt)
        zero = _PAD_MODES.get(self.pad_mode) == "constant"
        if self.pad and not zero:
            x = pad2d(x, self.pad, self.pad_mode)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), None,
                     self.stride, self.pad if zero else 0, self.dilation)
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


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d over the last axis that always normalizes by its running
    statistics, in `.train()` mode too, and never updates them: the
    descriptor net's BN while fine-tuning (the JAX package's
    `use_running_average=True`). The affine weight and bias are parameters
    and take gradients. The statistics are buffers, so a bf16 copy of the
    net keeps them float32 (and promotes the output to float32, as in the
    JAX package)."""

    def forward(self, x):
        return batch_norm_inference(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, self.eps)


class BatchNorm(FrozenBatchNorm):
    """The GAN nets' BatchNorm2d (gandtr_tpu/models/layers.py::BatchNorm).

    In `.eval()` it normalizes by its running statistics. In `.train()` it
    normalizes by the batch's mean and biased variance over (N, H, W) and
    moves the running statistics by momentum 0.1 towards the batch mean
    and the unbiased variance, in float32 for a bf16 or float32 input (a
    float64 one, a reference, stays float64), and counts the batch in
    `num_batches_tracked`, as torch's BatchNorm2d does."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean,
                         self.running_var, self.weight, self.bias,
                         training=True, momentum=self.momentum, eps=self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
        return y.permute(0, 2, 3, 1)


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
