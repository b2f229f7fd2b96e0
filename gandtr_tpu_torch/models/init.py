"""Weight initialization (counterpart of gandtr_tpu/models/init.py; the
reference's weight_initialization.py), drawn on the CPU from an explicit
`torch.Generator` in module order, each module's weight before its bias.

- The pix2pix schemes `normal_p2p`, `kaiming_p2p` and `xavier_p2p`: conv
  and linear weights from N(0, gain), N(0, sqrt(2 / fan_in)) or
  N(0, gain * sqrt(2 / (fan_in + fan_out))), biases 0; BatchNorm's scale
  from N(1, gain), its bias 0. The gain is the `initialize:` dict's
  `init_gain` (or `gain`); without one it is **0.2**, the reference's
  (its weight_initialization.py substitutes it when a config gives
  none), not the upstream pix2pix 0.02.
- The simple schemes `normal`, `uniform` and `he_normal` touch only conv
  and linear layers: weight and bias from N(0, 1) or U(0, 1), or the
  weight from N(0, sqrt(2 / fan_in)) and the bias 0.01. Norm layers keep
  their values. They take no parameters: any raises TypeError, as the
  reference's `assert not params` and the JAX dispatcher.

`fan_in` and `fan_out` are the JAX kernel's: kh*kw*in and kh*kw*out for a
conv, and the same for a transposed conv (its JAX kernel is
(kh, kw, in, out)); in and out for a linear layer.
"""
import math

import torch
from torch import nn

_CONV_LINEAR = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _fans(m):
    """(fan_in, fan_out) of a conv, transposed conv or linear layer."""
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
        k = w.shape[2] * w.shape[3]
        return w.shape[0] * k, w.shape[1] * k
    k = w[0, 0].numel() if w.dim() == 4 else 1
    return w.shape[1] * k, w.shape[0] * k  # (out, in, kh, kw) or (out, in)


def init_weights_p2p(module, generator, init_type="normal", gain=0.2):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _CONV_LINEAR):
                fan_in, fan_out = _fans(m)
                if init_type == "normal":
                    std = gain
                elif init_type == "kaiming":
                    std = math.sqrt(2.0 / fan_in)
                elif init_type == "xavier":
                    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
                else:
                    raise NotImplementedError(
                        "init [%s] not implemented" % init_type)
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d) and m.weight is not None:
                m.weight.copy_(1.0 + gain * torch.randn(m.weight.shape,
                                                        generator=generator))
                m.bias.zero_()
    return module


def init_weights_simple(module, generator, scheme="normal"):
    def draw(shape):
        if scheme == "uniform":
            return torch.rand(shape, generator=generator)
        return torch.randn(shape, generator=generator)

    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, _CONV_LINEAR):
                continue
            if scheme == "he_normal":
                m.weight.copy_(draw(m.weight.shape)
                               * math.sqrt(2.0 / _fans(m)[0]))
            elif scheme in ("normal", "uniform"):
                m.weight.copy_(draw(m.weight.shape))
            else:
                raise NotImplementedError(scheme)
            if m.bias is not None:
                # he_normal: "better than 0 if relu follows"
                m.bias.copy_(torch.full_like(m.bias, 0.01)
                             if scheme == "he_normal"
                             else draw(m.bias.shape))
    return module


def initialize_weights(module, weights="normal_p2p", seed=0, **kwargs):
    """Dispatcher (weight_initialization.py:79-94); `kwargs` are the rest
    of the `initialize:` dict."""
    g = torch.Generator().manual_seed(int(seed))
    if weights.endswith("_p2p"):
        gain = float(kwargs.get("init_gain", kwargs.get("gain", 0.2)))
        return init_weights_p2p(module, g, weights.rsplit("_", 1)[0], gain)
    if weights in ("normal", "uniform", "he_normal"):
        if kwargs:
            raise TypeError("weight scheme %r takes no parameters, got %r"
                            % (weights, sorted(kwargs)))
        return init_weights_simple(module, g, weights)
    raise NotImplementedError("weights scheme %s" % weights)
