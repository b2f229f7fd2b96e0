"""Multiscale resize (counterpart of gandtr_tpu/ops/resize.py::scale_resize
and ::masked_scale_resize).

The JAX package re-implements torch's `F.interpolate(scale_factor=s,
mode="bilinear", align_corners=False)`; here it is that very op. The output
size is int(H * s) x int(W * s), and coordinates map with 1/s.
"""
import torch.nn.functional as F

from gandtr_tpu_torch.ops.maskprop import MaskState


def scale_resize(x, scale):
    """x: (N, H, W, C) -> (N, int(H*s), int(W*s), C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def masked_scale_resize(x, state, scale):
    """`scale_resize` of each image's valid top-left rectangle in a padded
    (N, H, W, C) bucket. Each rectangle is cut out, made contiguous and
    resized alone, so the result is the exact-shape resize bit for bit on
    every device: it is the same op on the same tensor.

    Returns (y, new_state): y (N, int(H*s), int(W*s), C), zero outside the
    new rectangles of floor(h*s) x floor(w*s). The sizes come from
    `state.host_hw()`, so no size is read from the device here."""
    N, H, W, C = x.shape
    y = x.new_zeros((N, int(H * scale), int(W * scale), C))
    sizes = []
    for i, (h, w) in enumerate(state.host_hw()):
        r = scale_resize(x[i:i + 1, :h, :w].contiguous(), scale)
        h2, w2 = r.shape[1:3]
        y[i, :h2, :w2] = r[0]
        sizes.append((h2, w2))
    # the device sizes by the same double-precision floor as the resize's
    # output size, computed there: a list sent to the card would wait for
    # its stream
    hw = tuple((s.double() * scale).floor().to(s.dtype) for s in state.hw)
    return y, MaskState(hw, sizes)
