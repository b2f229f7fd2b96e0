"""Building-block layers of the generators (counterpart of
gandtr_tpu/models/layers.py), NHWC in and out.

Each parametrised layer subclasses its torch module, so its parameters keep
torch's names and layouts (`weight` OIHW for a conv, IOHW for a transposed
conv) and a reference `.pth` loads as it is. The JAX package's
`ops/fastconv.py` rewrites are TPU-MXU reformulations of the same convs and
map to plain `F.conv2d` here.

The blur-pool layers (`BlurDownsample`, `BlurUpsample`, the reference's
Downsample / Upsample) keep their binomial filter as the reference's
`filt` buffer. `Dropout` draws its masks from an explicit
`torch.Generator`.

dtype rules follow jnp's: a conv computes in promote(x, weight), so a bf16
activation after a float32 BatchNorm stays float32 through every later
conv, as in the JAX package (layers.py:57-59); a transposed conv computes in
the input's dtype; biases are added after the conv, in its dtype.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gandtr_tpu_torch.ops.norm import batch_norm_inference, instance_norm
from gandtr_tpu_torch.parallel import mesh

_PAD_MODES = {"zero": "constant", "constant": "constant",
              "reflect": "reflect", "refl": "reflect",
              "replicate": "replicate", "repl": "replicate"}


def tensor_key(t):
    """What identifies a tensor's current values, for caches made from it:
    its storage and version (an inference tensor has no version counter)."""
    return t.data_ptr(), (-1 if t.is_inference() else t._version)


def _reflect_cat(x, lo, hi, dim):
    """Reflect-pad one axis by `lo` and `hi` with flipped slices."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, lo).flip(dim), x,
                      x.narrow(dim, n - 1 - hi, hi).flip(dim)], dim)


def _replicate_cat(x, lo, hi, dim):
    """Replicate-pad one axis by `lo` and `hi` with the edge slices."""
    n = x.shape[dim]

    def edge(i, k):
        size = list(x.shape)
        size[dim] = k
        return x.narrow(dim, i, 1).expand(size)
    return torch.cat([edge(0, lo), x, edge(n - 1, hi)], dim)


def pad2d(x, pad, mode="zero"):
    """Pad the spatial dims of an NHWC tensor: `pad` is an int for every
    side or (top, bottom, left, right). Returns an NHWC-contiguous tensor.

    Reflect and replicate pads are built from slices: their backward then
    sums a border pixel's gradients in a fixed order, where the CUDA
    backwards of `F.pad(mode="reflect" / "replicate")` add them with
    atomics, in any order."""
    if mode not in _PAD_MODES:
        raise NotImplementedError("pad mode %s" % mode)
    t, b, l, r = (pad,) * 4 if isinstance(pad, int) else pad
    kind = _PAD_MODES[mode]
    if kind == "reflect":
        return _reflect_cat(_reflect_cat(x, t, b, 1), l, r, 2)
    if kind == "replicate":
        return _replicate_cat(_replicate_cat(x, t, b, 1), l, r, 2)
    y = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b))
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
    `num_batches_tracked`, as torch's BatchNorm2d does.

    Inside a data-parallel step (parallel/mesh.py) the batch is the global
    one: the mean and variance are all-reduced over the ranks, each rank
    holding an equal share of the rows."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        ctx = mesh.active()
        if ctx is not None and ctx.sync_batchnorm and ctx.world > 1:
            return self._global_forward(x, ctx.world)
        y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean,
                         self.running_var, self.weight, self.bias,
                         training=True, momentum=self.momentum, eps=self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
        return y.permute(0, 2, 3, 1)

    def _global_forward(self, x, world):
        """The training form over the global batch: the mean, then the
        biased variance about it, each a sum all-reduced over the ranks
        (autograd carries the gradients of the statistics back to every
        rank's rows)."""
        C = x.shape[-1]
        flat = x.reshape(-1, C)
        count = flat.shape[0] * world
        mean = mesh.all_reduce_sum(flat.sum(0)) / count
        centred = flat - mean
        var = mesh.all_reduce_sum((centred * centred).sum(0)) / count
        y = centred * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(
                m * var.detach() * (count / (count - 1)))
            self.num_batches_tracked.add_(1)
        return y.reshape(x.shape)


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


def binomial_filter(size):
    """The normalized 2-D binomial filter of the blur-pool layers
    (`size` 1 to 7), float32, as the JAX package's `_binomial_filter`."""
    a = {1: [1.0], 2: [1.0, 1.0], 3: [1.0, 2.0, 1.0],
         4: [1.0, 3.0, 3.0, 1.0], 5: [1.0, 4.0, 6.0, 4.0, 1.0],
         6: [1.0, 5.0, 10.0, 10.0, 5.0, 1.0],
         7: [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0]}[size]
    f = np.outer(a, a)
    return (f / f.sum()).astype(np.float32)


class _Blur(nn.Module):
    """A depthwise binomial filter kept as the reference's `filt` buffer,
    (C, 1, k, k). The filter is a constant: a state without it (the JAX
    package's variables carry none) loads and keeps it."""

    def __init__(self, channels, filt_size, scale=1.0):
        super().__init__()
        self.channels, self.filt_size = channels, filt_size
        f = torch.from_numpy(binomial_filter(filt_size)) * scale
        self.register_buffer("filt", f[None, None].repeat(channels, 1, 1, 1))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)
        if prefix + "filt" in missing_keys:
            missing_keys.remove(prefix + "filt")


class BlurDownsample(_Blur):
    """Antialiased downsampling (the reference's Downsample,
    p2p_networks.py:72-96): a reflect pad, then the binomial blur with
    stride, one filter a channel. The filter is taken in the input's dtype
    (exact in bf16: its entries are small dyadic fractions). NHWC."""

    def __init__(self, channels, filt_size=3, stride=2, pad_type="reflect",
                 pad_off=0):
        super().__init__(channels, filt_size)
        self.stride, self.pad_type, self.pad_off = stride, pad_type, pad_off
        lo, hi = (filt_size - 1) // 2, int(np.ceil((filt_size - 1) / 2.0))
        self.pad = (lo + pad_off, hi + pad_off, lo + pad_off, hi + pad_off)

    def forward(self, x):
        s = self.stride
        if self.filt_size == 1:
            if self.pad_off:
                x = pad2d(x, self.pad, self.pad_type)
            return x[:, ::s, ::s, :]
        x = pad2d(x, self.pad, self.pad_type)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.filt.to(x.dtype),
                     stride=s, groups=x.shape[-1])
        return y.permute(0, 2, 3, 1)


class BlurUpsample(_Blur):
    """Antialiased upsampling (the reference's Upsample,
    p2p_networks.py:107-130): a replicate pad of 1, a depthwise transposed
    convolution with the binomial filter times stride², one row and column
    cut at the start, and at the end too for an even filter. NHWC."""

    def __init__(self, channels, filt_size=4, stride=2, pad_type="repl"):
        super().__init__(channels, filt_size, scale=float(stride ** 2))
        self.stride, self.pad_type = stride, pad_type

    def forward(self, x):
        x = pad2d(x, 1, self.pad_type)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.filt.to(x.dtype),
                               stride=self.stride,
                               padding=1 + (self.filt_size - 1) // 2,
                               groups=x.shape[-1])[:, :, 1:, 1:]
        if self.filt_size % 2 == 0:
            y = y[:, :, :-1, :-1]
        return y.permute(0, 2, 3, 1)


class Dropout(nn.Module):
    """Dropout (zero with probability p, scale the rest by 1 / (1 - p)) in
    `.train()`, its mask drawn from the explicit `torch.Generator` set as
    `generator` (on its own device; the mask then moves to the input's),
    so a seeded run draws the same masks on any device. The identity in
    `.eval()`."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        if self.generator is None:
            raise ValueError("dropout in training draws from an explicit "
                             "torch.Generator: set the module's `generator`")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=self.generator.device) >= self.p
        return x * keep.to(x.device, x.dtype) / (1.0 - self.p)
