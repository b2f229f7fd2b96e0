"""CLAHE (Contrast-Limited Adaptive Histogram Equalization) on uint8
tensors, bit-exact vs cv2.createCLAHE.

Counterpart of gandtr_tpu/ops/clahe.py (`clahe_u8`, `channel_clahe`,
`image_clahe`, `image_colorspace_clahe`, `clahe_u8_dispatch`). Every
descriptor input goes through LAB-CLAHE (clip 1.0, grid 8x8); the image
functions take every space of ops/colorspace.py, and CLAHE always runs on
the truncated uint8 first channel of the normalized space. Algorithm
(OpenCV clahe.cpp semantics):

  1. pad right/bottom with BORDER_REFLECT_101 so H, W divide the tile grid
     (cv2 pads a FULL extra tile on an axis that already divides whenever
     the other axis does not)
  2. per-tile 256-bin histogram
  3. clip at max(int(clip_limit * tile_area / 256), 1); redistribute the
     excess floor-uniformly, the remainder to every (256//residual)-th bin
  4. LUT per tile: round_half_even(cumsum * lut_scale), lut_scale the
     correctly rounded float32 of 255 / tile_area
  5. per-pixel bilinear interpolation between the 4 neighbouring tile LUTs
     with cv2's float32 coordinate chain `pos * (1/ts) - 0.5`, each product
     and sum rounded on its own (no FMA), round-half-even to uint8

`clahe_u8` dispatches by the tensor's device: a CUDA tensor goes to the
hand-written kernel K1 (kernels/clahe.py), a CPU tensor to
`clahe_u8_plain`. Both take a whole batch (N, H, W) at once. The dispatch
is the custom op `gandtr::clahe_u8` (ops/library.py), so `torch.export`
traces it as one node.

The masked form (`clahe_u8_masked`, counterpart of the JAX package's
`clahe_u8_masked`) runs on a padded bucket (N, H, W) with each image's
valid top-left (h, w) rectangle given as an (N, 2) int32 tensor on the same
device, and computes cv2's result on the exact (h, w) image: the geometry
(pad rule, tile sizes, clip limit, LUT scale, interpolation coordinates)
comes from each image's own (h, w) on the device, never through the host.
The band outside the rectangle is 0. A CUDA batch goes to K4
(kernels/clahe_masked.py), a CPU batch to `clahe_u8_masked_plain`. K1 and
K4 are one CUDA kernel (csrc/clahe.cu) in its static and masked modes.
"""
import numpy as np
import torch

from gandtr_tpu_torch.ops import colorspace as cs
from gandtr_tpu_torch.ops import library


def _grid(grid_size):
    if isinstance(grid_size, int):
        return grid_size, grid_size
    return int(grid_size[0]), int(grid_size[1])


def clahe_geometry(H, W, clip_limit, grid_size):
    """cv2's tile geometry for an (H, W) image: (tile_h, tile_w, climit,
    lut_scale). lut_scale is float32; rounding the float64 quotient to float32
    equals the correctly rounded float32 division (53 >= 2*24 + 2 bits)."""
    ty, tx = _grid(grid_size)
    if H % ty == 0 and W % tx == 0:
        pad_h = pad_w = 0
    else:
        pad_h = ty - (H % ty)
        pad_w = tx - (W % tx)
    tile_h = (H + pad_h) // ty
    tile_w = (W + pad_w) // tx
    area = tile_h * tile_w
    if clip_limit > 0:
        climit = max(int(clip_limit * area / 256.0), 1)
    else:
        climit = area  # no clipping
    return tile_h, tile_w, climit, np.float32(255.0 / area)


def reflect101(idx, n):
    """BORDER_REFLECT_101 index map onto [0, n) (cv2 borderInterpolate)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    idx = idx.remainder(period)
    return torch.where(idx >= n, period - idx, idx)


def _clip_histogram(hist, climit):
    """Clip (..., 256) int histograms at `climit`, redistribute the excess."""
    clipped = (hist - climit).clamp(min=0).sum(dim=-1, keepdim=True)
    hist = torch.minimum(hist, torch.as_tensor(climit, device=hist.device))
    redist = clipped // 256
    residual = clipped - redist * 256          # (..., 1) in [0, 255]
    hist = hist + redist
    # residual goes to bins j with j % step == 0 and j // step < residual
    step = (256 // residual.clamp(min=1)).clamp(min=1)
    bins = torch.arange(256, device=hist.device)
    bonus = (bins % step == 0) & (bins // step < residual)
    return hist + bonus.to(hist.dtype)


def _round_half_even_u8(x):
    """cv::saturate_cast<uchar>(float): round-half-to-even then clamp."""
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def tile_coords(n, tsize, tcount):
    """cv2's float32 interpolation coordinates along one axis, in numpy f32:
    (i1, i2, a, 1 - a) for positions 0..n-1."""
    inv = np.float32(1.0) / np.float32(tsize)
    f = np.arange(n, dtype=np.float32) * inv - np.float32(0.5)
    i1 = np.floor(f).astype(np.int64)
    a = (f - i1).astype(np.float32)
    i2 = np.clip(i1 + 1, 0, tcount - 1)
    i1 = np.clip(i1, 0, tcount - 1)
    return i1, i2, a, (np.float32(1.0) - a).astype(np.float32)


def clahe_u8_plain(img, clip_limit=4.0, grid_size=(8, 8)):
    """The plain PyTorch version of K1. img: (N, H, W) or (H, W) uint8."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[None]
    N, H, W = img.shape
    ty, tx = _grid(grid_size)
    tile_h, tile_w, climit, lut_scale = clahe_geometry(H, W, clip_limit,
                                                       (ty, tx))
    dev = img.device
    T = ty * tx

    ys = reflect101(torch.arange(ty * tile_h, device=dev), H)
    xs = reflect101(torch.arange(tx * tile_w, device=dev), W)
    padded = img[:, ys][:, :, xs]
    tiles = padded.reshape(N, ty, tile_h, tx, tile_w).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(N, T, tile_h * tile_w).long()
    ids = tiles + 256 * torch.arange(N * T, device=dev).view(N, T, 1)
    hist = torch.bincount(ids.flatten(), minlength=N * T * 256)
    hist = _clip_histogram(hist.view(N, T, 256), climit)
    cdf = hist.cumsum(dim=-1).to(torch.float32)
    lut = _round_half_even_u8(cdf * torch.tensor(lut_scale, device=dev))

    def axis(n, ts, tc):
        return [torch.from_numpy(v).to(dev)
                for v in tile_coords(n, ts, tc)]

    y1, y2, ya, oma_y = axis(H, tile_h, ty)
    x1, x2, xa, oma_x = axis(W, tile_w, tx)
    lutf = lut.view(N, T * 256).to(torch.float32)
    v = img.long().view(N, H * W)

    def corner(yi, xi):
        base = ((yi[:, None] * tx + xi[None, :]) * 256).view(1, H * W)
        return lutf.gather(1, base + v).view(N, H, W)

    xa, oma_x = xa[None, None, :], oma_x[None, None, :]
    ya, oma_y = ya[None, :, None], oma_y[None, :, None]
    # separate eager ops: every product and sum rounds on its own, as in cv2
    top = corner(y1, x1) * oma_x + corner(y1, x2) * xa
    bot = corner(y2, x1) * oma_x + corner(y2, x2) * xa
    out = _round_half_even_u8(top * oma_y + bot * ya)
    return out[0] if squeeze else out


def clahe_u8(img, clip_limit=4.0, grid_size=(8, 8)):
    """Dispatch by device through the custom op `gandtr::clahe_u8`
    (ops/library.py): the K1 kernel for a CUDA tensor, the plain version
    for a CPU tensor. img: (N, H, W) or (H, W) uint8."""
    ty, tx = _grid(grid_size)
    return library.clahe_u8(img, float(clip_limit), ty, tx)


def masked_geometry(hw, clip_limit, grid_size):
    """cv2's geometry of each valid rectangle, on hw's device: (tile_h,
    tile_w, climit, lut_scale), each (N,). The pad rule is clahe_geometry's;
    climit is int(f32(clip) * f32(area) / 256) as the JAX package computes
    it; lut_scale the correctly rounded float32 of 255 / area."""
    ty, tx = _grid(grid_size)
    h, w = hw[:, 0].long(), hw[:, 1].long()
    both = (h % ty == 0) & (w % tx == 0)
    tile_h = (h + torch.where(both, 0, ty - h % ty)) // ty
    tile_w = (w + torch.where(both, 0, tx - w % tx)) // tx
    area = tile_h * tile_w
    if clip_limit > 0:
        climit = (torch.tensor(clip_limit, dtype=torch.float32)
                  .to(hw.device) * area.float() / 256.0).long().clamp(min=1)
    else:
        climit = area
    lut_scale = (255.0 / area.double()).float()
    return tile_h, tile_w, climit, lut_scale


def clahe_u8_masked_plain(img, hw, clip_limit=4.0, grid_size=(8, 8)):
    """The plain PyTorch version of K4 with its LUT build. img: (N, H, W)
    uint8 bucket; hw: (N, 2) int32 valid sizes. The histogram is taken over
    the virtual reflect-101 padded image (the JAX package's
    `hist_form="virtual"`, bit-identical to its band form)."""
    N, H, W = img.shape
    ty, tx = _grid(grid_size)
    T = ty * tx
    dev = img.device
    tile_h, tile_w, climit, lut_scale = masked_geometry(hw, clip_limit,
                                                        (ty, tx))
    h, w = hw[:, 0].long(), hw[:, 1].long()
    n_idx = torch.arange(N, device=dev)

    # (1) histograms over the padded rect (ty*tile_h, tx*tile_w) of the
    # virtual image: reflect-101 about the valid boundary, one bounce,
    # clamped into the buffer
    yv = torch.arange(H + ty, device=dev)[None, :]
    xv = torch.arange(W + tx, device=dev)[None, :]
    ry = torch.where(yv < h[:, None], yv, 2 * h[:, None] - 2 - yv)
    rx = torch.where(xv < w[:, None], xv, 2 * w[:, None] - 2 - xv)
    virt = img[n_idx[:, None, None], ry.clamp(0, H - 1)[:, :, None],
               rx.clamp(0, W - 1)[:, None, :]].long()
    inside = ((yv < (ty * tile_h)[:, None])[:, :, None]
              & (xv < (tx * tile_w)[:, None])[:, None, :])
    tid = ((yv // tile_h[:, None]).clamp(max=ty - 1)[:, :, None] * tx
           + (xv // tile_w[:, None]).clamp(max=tx - 1)[:, None, :])
    ids = ((n_idx[:, None, None] * T + tid) * 256 + virt).flatten()
    hist = torch.zeros(N * T * 256, dtype=torch.long, device=dev)
    hist.scatter_add_(0, ids, inside.long().flatten())
    hist = _clip_histogram(hist.view(N, T, 256), climit.view(N, 1, 1))
    cdf = hist.cumsum(dim=-1).to(torch.float32)
    lutf = _round_half_even_u8(cdf * lut_scale.view(N, 1, 1)).view(
        N, T * 256).to(torch.float32)

    # (2) interpolation over the whole buffer with each image's geometry
    def axis(n, ts, tc):
        inv = (1.0 / ts.double()).float()
        f = torch.arange(n, device=dev, dtype=torch.float32)[None, :] \
            * inv[:, None] - 0.5
        fl = torch.floor(f)
        a = f - fl
        i = fl.long()
        return i.clamp(0, tc - 1), (i + 1).clamp(0, tc - 1), a, 1.0 - a

    y1, y2, ya, oma_y = axis(H, tile_h, ty)
    x1, x2, xa, oma_x = axis(W, tile_w, tx)
    v = img.long().view(N, H * W)

    def corner(yi, xi):
        base = (yi[:, :, None] * tx + xi[:, None, :]) * 256
        return lutf.gather(1, base.view(N, H * W) + v).view(N, H, W)

    xa, oma_x = xa[:, None, :], oma_x[:, None, :]
    ya, oma_y = ya[:, :, None], oma_y[:, :, None]
    # separate eager ops: every product and sum rounds on its own, as in cv2
    top = corner(y1, x1) * oma_x + corner(y1, x2) * xa
    bot = corner(y2, x1) * oma_x + corner(y2, x2) * xa
    out = _round_half_even_u8(top * oma_y + bot * ya)
    valid = ((torch.arange(H, device=dev)[None, :] < h[:, None])[:, :, None]
             & (torch.arange(W, device=dev)[None, :] < w[:, None])[:, None, :])
    return out * valid


def clahe_u8_masked(img, hw, clip_limit=4.0, grid_size=(8, 8)):
    """Dispatch by device: K4 (LUT build + interpolation, one launch
    for the batch) for a CUDA tensor, the plain version for a CPU tensor.
    img: (N, H, W) uint8; hw: (N, 2) int32 on img's device."""
    if img.device.type == "cpu":
        return clahe_u8_masked_plain(img, hw, clip_limit, grid_size)
    from gandtr_tpu_torch.kernels.clahe_masked import clahe_u8_masked_cuda
    return clahe_u8_masked_cuda(img, hw, clip_limit, grid_size)


def channel_clahe_masked(chan, hw, clip_limit, grid_size):
    """channel_clahe of each image's valid rectangle; the band is 0."""
    u8 = (chan.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return clahe_u8_masked(u8.contiguous(), hw, clip_limit,
                           grid_size).to(torch.float32) / 255.0


def image_clahe_masked(img, hw, clip_limit=4.0, grid_size=8,
                       colorspace="lab"):
    """image_clahe of each valid rectangle of a padded (N, H, W, 3) batch;
    the colour conversions are per pixel, so only the CLAHE channel needs
    the geometry. Band pixels carry no meaning (callers re-mask)."""
    spc = cs.rgb2normspace(img, colorspace)
    L = channel_clahe_masked(spc[..., 0], hw, clip_limit, grid_size)
    spc = torch.cat([L[..., None], spc[..., 1:]], dim=-1)
    return cs.normspace2rgb(spc, colorspace)


def channel_clahe(chan, clip_limit, grid_size):
    """float [0,1] channel (N, H, W) -> truncate to uint8 at 255 -> CLAHE ->
    /255 float (reference ChannelClahe.apply)."""
    u8 = (chan.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return clahe_u8(u8, clip_limit, grid_size).to(torch.float32) / 255.0


def image_clahe(img, clip_limit=4.0, grid_size=8, colorspace="lab"):
    """CLAHE on the lightness channel of `colorspace`, back to RGB.
    img: (N, H, W, 3) or (H, W, 3) float RGB in [0, 1]."""
    spc = cs.rgb2normspace(img, colorspace)
    L = channel_clahe(spc[..., 0], clip_limit, grid_size)
    spc = torch.cat([L[..., None], spc[..., 1:]], dim=-1)
    return cs.normspace2rgb(spc, colorspace)


def image_colorspace_clahe(img, clip_limit=4.0, grid_size=8,
                           colorspace="lab"):
    """image_clahe without the way back: the normalized `colorspace` with
    its first channel CLAHE'd (reference ImageColorspaceClahe.apply)."""
    spc = cs.rgb2normspace(img, colorspace)
    L = channel_clahe(spc[..., 0], clip_limit, grid_size)
    return torch.cat([L[..., None], spc[..., 1:]], dim=-1)
