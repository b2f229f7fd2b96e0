"""Multiscale resize (counterpart of gandtr_tpu/ops/resize.py::scale_resize).

The JAX package re-implements torch's `F.interpolate(scale_factor=s,
mode="bilinear", align_corners=False)`; here it is that very op. The output
size is int(H * s) x int(W * s), and coordinates map with 1/s.
"""
import torch.nn.functional as F


def scale_resize(x, scale):
    """x: (N, H, W, C) -> (N, int(H*s), int(W*s), C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
