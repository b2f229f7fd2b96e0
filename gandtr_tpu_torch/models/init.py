"""Weight initialization (counterpart of gandtr_tpu/models/init.py): the
pix2pix schemes `normal_p2p` and `kaiming_p2p`, drawn on the CPU from an
explicit `torch.Generator` in module order.

As in the JAX package: conv and linear weights from N(0, gain) (normal) or
N(0, sqrt(2 / fan_in)) (kaiming), biases 0; BatchNorm's scale from
N(1, gain), its bias 0. The default gain is **0.2**, the reference's
(weight_initialization.py substitutes it when a config gives none), not
the upstream pix2pix 0.02. `fan_in` is the JAX kernel's: kh*kw*in for a
conv, and kh*kw*in for a transposed conv too (its JAX kernel is
(kh, kw, in, out)).
"""
import math

import torch
from torch import nn


def _fan_in(m):
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w[0].numel()  # conv (out, in, kh, kw) or linear (out, in)


def init_weights_p2p(module, generator, init_type="normal", gain=0.2):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                if init_type == "normal":
                    std = gain
                elif init_type == "kaiming":
                    std = math.sqrt(2.0 / _fan_in(m))
                else:
                    raise NotImplementedError(
                        "init [%s] is not ported yet" % init_type)
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d) and m.weight is not None:
                m.weight.copy_(1.0 + gain * torch.randn(m.weight.shape,
                                                        generator=generator))
                m.bias.zero_()
    return module


def initialize_weights(module, weights="normal_p2p", seed=0):
    """Dispatcher (weight_initialization.py:79-94) for the *_p2p schemes,
    at the reference's default gain."""
    if not weights.endswith("_p2p"):
        raise NotImplementedError("weights scheme %s is not ported yet"
                                  % weights)
    g = torch.Generator().manual_seed(int(seed))
    return init_weights_p2p(module, g, weights.rsplit("_", 1)[0])
