"""Bilinear resizes (counterpart of gandtr_tpu/ops/resize.py).

`scale_resize` and `masked_scale_resize`: the JAX package re-implements
torch's `F.interpolate(scale_factor=s, mode="bilinear",
align_corners=False)`; here it is that very op. The output size is
int(H * s) x int(W * s), and coordinates map with 1/s.

`bilinear_resize` to a given size (align_corners false, half-pixel
centres, no antialias: the JAX package's `bilinear_resize`) is two matrix
products with interpolation matrices made on the host from the JAX
coordinates. Its backward is two matrix products too, so it sums in a
fixed order on the card, where the CUDA backward of `F.interpolate` adds
with atomics.

`nearest_resize` is torch's `F.interpolate(mode="nearest")` to a given
size with the JAX package's float32 source index (floor(dst * in / out)),
a gather.

`dynamic_bilinear_resize_u8` is the device half of the GAN train chain's
scalecrop (`device_scalecrop`): a per-image resize of padded uint8 crops.
"""
import numpy as np
import torch
import torch.nn.functional as F

from gandtr_tpu_torch.ops.maskprop import MaskState


_MATRICES = {}


def _interp_matrix(out_n, in_n, device, scale=None):
    """(out_n, in_n) float32 matrix of the JAX package's `_source_coords`
    (float32 source coordinates, clamped at both ends): a source step of
    in / out, or 1 / scale where `scale` is given."""
    key = (out_n, in_n, str(device), scale)
    if key not in _MATRICES:
        step = in_n / out_n if scale is None else 1.0 / scale
        src = (np.arange(out_n, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(step) - np.float32(0.5)
        src = np.clip(src, np.float32(0.0), None)
        i0 = np.clip(np.floor(src).astype(np.int64), 0, in_n - 1)
        i1 = np.clip(i0 + 1, 0, in_n - 1)
        w1 = np.clip(src - i0.astype(np.float32), 0.0, 1.0).astype(np.float32)
        m = np.zeros((out_n, in_n), np.float32)
        rows = np.arange(out_n)
        np.add.at(m, (rows, i0), np.float32(1.0) - w1)
        np.add.at(m, (rows, i1), w1)
        _MATRICES[key] = torch.from_numpy(m).to(device)
    return _MATRICES[key]


def bilinear_resize(x, out_h, out_w, scale=None):
    """x: (N, H, W, C) float -> (N, out_h, out_w, C), torch-bilinear
    semantics; the identity where the size does not change. Give `scale`
    to mimic `F.interpolate(scale_factor=scale)`, whose coordinates step
    by 1 / scale, not in / out."""
    N, H, W, C = x.shape
    if (H, W) == (out_h, out_w) and scale in (None, 1, 1.0):
        return x
    ah = _interp_matrix(out_h, H, x.device, scale).to(x.dtype)
    aw = _interp_matrix(out_w, W, x.device, scale).to(x.dtype)
    y = torch.matmul(ah, x.permute(0, 3, 1, 2))       # (N, C, out_h, W)
    y = torch.matmul(y, aw.T)                          # (N, C, out_h, out_w)
    return y.permute(0, 2, 3, 1)


def nearest_resize(x, out_h, out_w):
    """x: (N, H, W, C) -> (N, out_h, out_w, C), torch's nearest: source
    index floorf(dst * float32(in / out)), in float32 as torch computes it
    (an exact integer floor differs where the product rounds across an
    integer)."""
    N, H, W, C = x.shape

    def src(out_n, in_n):
        step = np.float32(in_n) / np.float32(out_n)
        idx = np.floor(np.arange(out_n, dtype=np.float32) * step)
        return torch.from_numpy(np.clip(idx.astype(np.int64), 0,
                                        in_n - 1)).to(x.device)

    return x[:, src(out_h, H)][:, :, src(out_w, W)]


def dynamic_bilinear_resize_u8(imgs_u8, hws, out_h, out_w):
    """Each image's valid top-left (h, w) rectangle of a padded uint8
    batch, /255 in float32 and resized to (out_h, out_w) with half-pixel
    bilinear taps (cv2.resize's INTER_LINEAR formula and clamping), the
    rows first, then the columns, as the JAX package's
    `dynamic_bilinear_resize_u8`. imgs_u8: (N, Hp, Wp, C) uint8; hws: (N,
    2) integer valid sizes on the same device. The taps stay inside [0,
    h) x [0, w), so the pad never enters. Gathers and lerps: no host
    value is read."""
    x = imgs_u8.to(torch.float32) / 255.0
    hws = hws.to(device=x.device, dtype=torch.int64)

    def coords(out_n, in_n):
        """(N, out_n) taps i0, i1 and the weight of i1."""
        scale = in_n.to(torch.float32)[:, None] / out_n
        src = (torch.arange(out_n, dtype=torch.float32, device=x.device)
               + 0.5)[None] * scale - 0.5
        src = torch.clamp(src, min=0.0)
        top = (in_n - 1)[:, None]
        i0 = torch.minimum(torch.floor(src).to(torch.int64), top)
        i1 = torch.minimum(i0 + 1, top)
        frac = torch.clamp(src - i0.to(torch.float32), 0.0, 1.0)
        return i0, i1, frac

    n = torch.arange(x.shape[0], device=x.device)[:, None]
    y0, y1, wy = coords(out_h, hws[:, 0])
    x0, x1, wx = coords(out_w, hws[:, 1])
    wy = wy[:, :, None, None]
    rows = x[n, y0] * (1 - wy) + x[n, y1] * wy          # (N, out_h, Wp, C)
    wx = wx[:, None, :, None]
    return (rows[n, :, x0].permute(0, 2, 1, 3) * (1 - wx)
            + rows[n, :, x1].permute(0, 2, 1, 3) * wx)


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
