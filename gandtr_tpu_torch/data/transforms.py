"""Preprocessing with the reference's transform DSL (counterpart of
gandtr_tpu/data/transforms.py): the string `"pil2np | apply_clahe:1.0 |
totensor | normalize"` builds a Compose over the 26 transforms of the JAX
package's registry (`TRANSFORMS`): decoding and normalization, crops,
flips, scaling and noise, colorspaces and channel surgery, CLAHE, and
histogram matching. `DeviceScalecrop` is the scalecrop chain's host half
when its resize runs on the device (`device_scalecrop`).

A Compose takes one image or several (`compose(x, y)` -> [x', y']) and
returns one image where its chain ends with one, as the reference's
variadic Compose. A random transform (`random_crop`, `mirror`,
`gaussian_noise`, `scalecrop`) draws once for all the images, as the
reference's do, so the images of a tuple are cut alike; `gaussian_noise`
touches the first image only. `stackbatch`, `create_clahed` and
`replace_histogram` change how many images the chain carries. The draws
come from the module's RNG, reseeded each epoch (`seed_transforms`), in
the JAX package's order. `Compose.draw(sizes)` makes an item's draws ahead
of its decoding, following each image's shape through the chain (a
transform's `out_shapes`; one without it keeps the shape): the loader
calls it for its items in order on one thread, so a thread pool decodes
them in any order and each item still gets the draws the sequential loop
would give it.

The host transforms work on CPU images: PIL image or uint8 array in,
(H, W, C) float32 CPU tensor out (NHWC like the JAX package; CLAHE runs
its plain version there). `split_device_transform` gives the same
preprocessing as a batch function on the tensor's device, where CLAHE is
one launch of the K1 kernel for the whole batch. The generators'
pipeline `pil2np | totensor | normalize` splits the same way (no CLAHE),
and `device_quantize_rgb` turns a generator's output back into uint8 RGB.
"""
import math
import threading

import numpy as np
import torch
from PIL import Image

from gandtr_tpu_torch.ops import clahe as clahe_ops
from gandtr_tpu_torch.ops import colorspace as cs_ops


# the host transforms' random draws, reseeded each epoch (the reference's
# per-epoch seed)
_RNG = np.random.RandomState(0)
_RNG_LOCK = threading.Lock()


def seed_transforms(seed):
    """Reseed the host transforms' random draws for an epoch."""
    global _RNG
    _RNG = np.random.RandomState(seed)


def _shapes_of(sizes):
    """(h, w) or (h, w, c) sizes -> (h, w, c) shapes; a decoded image is
    RGB."""
    return [tuple(int(v) for v in s) + ((3,) if len(s) == 2 else ())
            for s in sizes]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, *pics, draws=None):
        """One image out -> that image; several -> a list. `draws` (from
        `draw`) replaces the random transforms' own draws."""
        out = list(pics)
        for i, t in enumerate(self.transforms):
            if hasattr(t, "joint"):
                out = t.joint(out, None if draws is None else draws[i])
            else:
                out = [t(p) for p in out]
        return out[0] if len(out) == 1 else out

    def draw(self, sizes):
        """The random draws of this chain for images of `sizes` [(h, w),
        ...]: a list with an entry per transform (None where it draws
        nothing), drawn in the chain's order at each step's input shapes."""
        out, shapes = [], _shapes_of(sizes)
        for t in self.transforms:
            d = t.draw(shapes) if hasattr(t, "draw") else None
            out.append(d)
            if hasattr(t, "out_shapes"):
                shapes = t.out_shapes(shapes, d)
        return out


def _slice_len(n, start, stop):
    return len(range(n)[start:stop])


def _to_tensor(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


class Pil2Numpy:
    """PIL image or uint array -> float32 (H, W, C) in [0, 1]."""

    def __call__(self, pic):
        if isinstance(pic, Image.Image):
            pic = np.asarray(pic.convert("RGB"))
        elif not isinstance(pic, np.ndarray):
            raise ValueError("Unsupported type '%s'" % type(pic))
        if pic.dtype == np.uint8:
            pic = pic.astype(np.float32) / 255.0
        elif pic.dtype == np.uint16:
            pic = pic.astype(np.float32) / 65535.0
        return torch.from_numpy(np.ascontiguousarray(pic, np.float32))


class ToTensor:
    """Layout stays HWC (the public layout); float32, contiguous."""

    def __call__(self, pic):
        return torch.as_tensor(pic, dtype=torch.float32).contiguous()


class Normalize:
    """(x - mean) / std over the channels; with `strict_shape` false an
    image may have fewer channels than the statistics (their first ones
    apply)."""

    def __init__(self, mean, std, strict_shape=True):
        if isinstance(strict_shape, str):
            strict_shape = strict_shape.lower() != "false"
        if len(mean) != len(std):
            raise ValueError("mean and std of different lengths")
        self.mean = torch.tensor(mean, dtype=torch.float32)
        self.std = torch.tensor(std, dtype=torch.float32)
        self.strict_shape = bool(strict_shape)

    def __call__(self, pic):
        c = pic.shape[-1]
        if c != len(self.mean) if self.strict_shape else c > len(self.mean):
            raise ValueError("normalize: %d channels, statistics of %d"
                             % (c, len(self.mean)))
        return (pic - self.mean[:c].to(pic.device)) \
            / self.std[:c].to(pic.device)


def _as_array(pic):
    return pic.numpy() if isinstance(pic, torch.Tensor) else np.asarray(pic)


def _as_image(pic):
    return pic if isinstance(pic, torch.Tensor) else torch.as_tensor(
        np.asarray(pic))


class StackBatch:
    """Concatenate the images along channels (the reference cats CHW
    tensors on axis 0; in HWC that is the last axis): n images -> 1."""

    def joint(self, pics, draws=None):
        return [torch.cat([_as_image(p) for p in pics], dim=-1)]

    def out_shapes(self, shapes, draws):
        return [shapes[0][:2] + (sum(s[2] for s in shapes),)]


class NanCheck:
    def __call__(self, pic):
        if np.isnan(_as_array(pic)).any():
            raise ValueError("Nan value occured in input")
        return pic


# ---------------------------------------------------------------------------
# crops, flips, scaling and noise (augmentation_transforms.py)
# ---------------------------------------------------------------------------

class RandomCrop:
    """`random_crop:<h>[_<w>]`: one random (h, w) window, placed by the
    first image, cut from every image."""

    def __init__(self, size):
        size = _parse_tuple(size, int)
        self.size = size * 2 if len(size) == 1 else size
        if len(self.size) != 2:
            raise ValueError("Invalid tuple of size %s, required 2"
                             % len(self.size))

    def draw(self, shapes):
        th, tw = self.size
        h, w = shapes[0][:2]
        with _RNG_LOCK:
            i = _RNG.randint(0, h - th + 1)
            j = _RNG.randint(0, w - tw + 1)
        return int(i), int(j)

    def joint(self, pics, draws=None):
        if draws is None:
            draws = self.draw([_as_array(p).shape for p in pics])
        (i, j), (th, tw) = draws, self.size
        return [_to_tensor(_as_array(p)[i:i + th, j:j + tw]) for p in pics]

    def out_shapes(self, shapes, draws):
        (i, j), (th, tw) = draws, self.size
        return [(_slice_len(s[0], i, i + th), _slice_len(s[1], j, j + tw))
                + s[2:] for s in shapes]


class RandomHorizontalFlip:
    """`mirror[:<p>]`: every image flipped left-right with probability p."""

    def __init__(self, p=0.5):
        self.p = float(p)

    def draw(self, shapes):
        with _RNG_LOCK:
            return bool(_RNG.rand() < self.p)

    def joint(self, pics, draws=None):
        if draws is None:
            draws = self.draw(None)
        if draws:
            return [_to_tensor(np.flip(_as_array(p), axis=1)) for p in pics]
        return list(pics)


def _center_window(n, size):
    """The JAX package's centre window along one axis: [floor(pad),
    -ceil(pad) or None) with pad = (n - size) / 2."""
    pad = (n - size) / 2
    return int(np.floor(pad)), (-int(np.ceil(pad)) or None)


class CenterCrop:
    """`center_crop:<w>[_<h>]`: the centred window of each image."""

    def __init__(self, size):
        self.size = np.array(_parse_tuple(size, int))[::-1]

    def _windows(self, shape):
        size = np.broadcast_to(self.size, (2,))
        return [_center_window(shape[k], size[k]) for k in (0, 1)]

    def __call__(self, pic):
        arr = _as_array(pic)
        (y0, y1), (x0, x1) = self._windows(arr.shape)
        return _to_tensor(arr[y0:y1, x0:x1])

    def out_shapes(self, shapes, draws):
        out = []
        for s in shapes:
            (y0, y1), (x0, x1) = self._windows(s)
            out.append((_slice_len(s[0], y0, y1), _slice_len(s[1], x0, x1))
                       + s[2:])
        return out


class SquareCrop:
    """`square_crop`: the centred square of each image's shorter side."""

    @staticmethod
    def _windows(shape):
        side = min(shape[:2])
        out = []
        for n in shape[:2]:
            pad = (n - side) / 2
            out.append((int(np.floor(pad)), n - int(np.ceil(pad))))
        return out

    def __call__(self, pic):
        arr = _as_array(pic)
        (y0, y1), (x0, x1) = self._windows(arr.shape)
        return _to_tensor(arr[y0:y1, x0:x1])

    def out_shapes(self, shapes, draws):
        return [(min(s[:2]), min(s[:2])) + s[2:] for s in shapes]


class AdditiveGaussianNoise:
    """`gaussian_noise:<sigma>`: N(0, sigma) noise (drawn in float64 at
    the first image's shape) added to the first image, clipped to [0, 1];
    the other images pass unchanged."""

    def __init__(self, sigma):
        self.sigma = float(sigma)

    def draw(self, shapes):
        with _RNG_LOCK:
            return _RNG.normal(0, self.sigma, shapes[0])

    def joint(self, pics, draws=None):
        first = _as_array(pics[0])
        if draws is None:
            draws = self.draw([first.shape])
        noisy = np.clip(first + draws, 0, 1).astype(np.float32)
        return [_to_tensor(noisy)] + list(pics[1:])


def _linear_coeffs(dst, src):
    """cv2.resize INTER_LINEAR's taps and weights along one axis (its
    float path): the source coordinate (d + 0.5) * scale - 0.5 and its
    fraction in double precision, the fraction rounded to float32 and its
    complement taken there; the taps clamped to the edge pixel."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    s0 = np.floor(f).astype(np.int64)
    f = (f - s0).astype(np.float32)
    out = (s0 < 0) | (s0 >= src - 1)
    f[out] = 0.0
    s0 = np.clip(s0, 0, src - 1)
    s1 = np.minimum(s0 + 1, src - 1)
    return s0, s1, (np.float32(1.0) - f).astype(np.float32), f


def resize_linear(img, out_w, out_h):
    """`cv2.resize(img, (out_w, out_h))` of a float32 (H, W[, C]) array,
    the JAX package's scalecrop resize, in numpy: the same taps and
    weights, the horizontal pass first; each product and sum rounds to
    float32 on its own (cv2's vector code may fuse a multiply-add: within
    an ulp)."""
    img = np.asarray(img, np.float32)
    x0, x1, a0, a1 = _linear_coeffs(out_w, img.shape[1])
    y0, y1, b0, b1 = _linear_coeffs(out_h, img.shape[0])
    col = (1, -1) + (1,) * (img.ndim - 2)
    row = (-1,) + (1,) * (img.ndim - 1)
    a0, a1 = a0.reshape(col), a1.reshape(col)
    rows = np.unique(np.concatenate([y0, y1]))
    band = img[rows]
    h = np.empty((img.shape[0], out_w) + img.shape[2:], np.float32)
    h[rows] = band[:, x0] * a0 + band[:, x1] * a1
    return h[y0] * b0.reshape(row) + h[y1] * b1.reshape(row)


class RandomScaleCrop:
    """`scalecrop:<w>_<h>:<lo>_<hi>` (augmentation_transforms.py:100-144):
    one random scale in [max(lo, size / min side), hi] and one random
    offset for all the images, a crop of ceil(size / scale), resized to
    (w, h) as cv2 does. Images already at (h, w) pass unchanged. The size
    is compared with the images' (h, w) in (w, h) order, as in the
    reference."""

    def __init__(self, size, scale=(0.5, 0.8)):
        self.size = np.array(_parse_tuple(size, int))
        self.scale = _parse_tuple(scale, float)

    def draw(self, sizes):
        """(offset, cropped size) for images of `sizes`, or None."""
        mn = _scalecrop_min_size(self.size, sizes)
        if mn is None:
            return None
        if not (self.size <= mn).all():
            raise ValueError("scalecrop %s does not fit images of %s"
                             % (self.size, mn))
        lowest = max(float(np.max(self.size / mn)), self.scale[0])
        with _RNG_LOCK:
            scale = _RNG.rand() * (self.scale[1] - lowest) + lowest
            cropped = np.ceil(self.size[::-1] / scale).astype(int)
            if not (mn >= cropped).all():
                raise ValueError("scalecrop: crop %s of %s" % (cropped, mn))
            offset = [_RNG.randint(0, x + 1) for x in mn - cropped]
        return offset, cropped

    def joint(self, pics, draws=None):
        pics = [_as_array(p) for p in pics]
        if draws is None:
            draws = self.draw([p.shape[:2] for p in pics])
        return _scalecrop_cut(self.size, pics, draws)

    def crop_only(self, *pics, draws=None):
        """The crops of `joint` without the resize: the same draws, made
        the same way when `draws` is None. Returns (crops, (w, h)), or
        (pics, None) where `joint` passes the images through."""
        pics = [_as_array(p) for p in pics]
        if draws is None:
            draws = self.draw([p.shape[:2] for p in pics])
        if draws is None:
            return pics, None
        (y, x), (ch, cw) = draws
        return [p[y:y + ch, x:x + cw] for p in pics], tuple(self.size)

    @property
    def max_crop_side(self):
        """The longest crop side any draw can make: ceil(size / lo)."""
        return int(np.max(np.ceil(self.size[::-1] / self.scale[0])))

    def out_shapes(self, shapes, draws):
        return _scalecrop_out_shapes(self.size, shapes, draws)


def _scalecrop_min_size(size, sizes):
    """The images' smallest (h, w), or None where they all are at (h, w)
    = size[::-1] already (they then pass unchanged)."""
    sizes = [tuple(s[:2]) for s in sizes]
    if len(sizes) == 1 or sizes[0] == sizes[1]:
        if (np.asarray(sizes[0]) == size[::-1]).all():
            return None
    return np.min(np.asarray(sizes), axis=0)


def _scalecrop_cut(size, pics, box):
    """The crop `box` ((y, x), (h, w)) of each image resized to size (w,
    h) as cv2 does; the images unchanged where `box` is None."""
    if box is None:
        return [torch.from_numpy(np.ascontiguousarray(p)) for p in pics]
    (y, x), (ch, cw) = box
    w, h = size
    return [torch.from_numpy(resize_linear(p[y:y + ch, x:x + cw], w, h))
            for p in pics]


def _scalecrop_out_shapes(size, shapes, box):
    if box is None:
        return shapes
    w, h = size
    return [(int(h), int(w)) + s[2:] for s in shapes]


class CenterScaleCrop:
    """`centerscalecrop:<w>_<h>[:<scale>]`: the centred crop of
    ceil(size / scale), resized to (w, h) as cv2 does; no random draw.
    Images already at (h, w) pass unchanged."""

    def __init__(self, size, scale=0.6):
        self.size = np.array(_parse_tuple(size, int))
        self.scale = float(scale)

    def _box(self, shapes):
        mn = _scalecrop_min_size(self.size, shapes)
        if mn is None:
            return None
        cropped = np.ceil(self.size[::-1] / self.scale).astype(int)
        if not (mn >= cropped).all():
            raise ValueError("centerscalecrop: crop %s of %s" % (cropped, mn))
        return [int(x) // 2 for x in mn - cropped], cropped

    def joint(self, pics, draws=None):
        pics = [_as_array(p) for p in pics]
        return _scalecrop_cut(self.size, pics, self._box([p.shape
                                                          for p in pics]))

    def out_shapes(self, shapes, draws):
        return _scalecrop_out_shapes(self.size, shapes, self._box(shapes))


class DeviceScalecrop:
    """The host half of `data.train.device_scalecrop`: each image's crop
    from the draws of `sc` (a RandomScaleCrop; the loader plans them as
    for the host chain, so both chains cut the same boxes), as uint8 in
    the top-left corner of a zero (pad, pad, 3) buffer with pad =
    `sc.max_crop_side`, followed by its (h, w). The /255, the resize to
    the scalecrop's size and the normalization run on the device
    (ops/resize.py::dynamic_bilinear_resize_u8). Returns [img_u8, hw, ...]
    for each input image."""

    def __init__(self, sc):
        self.sc = sc
        self.pad = sc.max_crop_side

    def draw(self, sizes):
        return self.sc.draw(sizes)

    def __call__(self, *pics, draws=None):
        arrs = []
        for p in pics:
            a = np.asarray(p.convert("RGB")) if isinstance(p, Image.Image) \
                else np.asarray(p)
            if a.dtype != np.uint8:
                raise ValueError("device scalecrop takes decoded uint8 "
                                 "images, got %s" % a.dtype)
            arrs.append(a)
        crops, _ = self.sc.crop_only(*arrs, draws=draws)
        out = []
        for c in crops:
            h, w = min(c.shape[0], self.pad), min(c.shape[1], self.pad)
            buf = np.zeros((self.pad, self.pad, 3), np.uint8)
            buf[:h, :w] = c[:h, :w]
            out.extend([buf, np.asarray([h, w], np.int32)])
        return out


def parse_device_scalecrop(transforms_str, mean_std):
    """The pieces of the device scalecrop for exactly `pil2np |
    scalecrop:SIZE[:SCALE] | totensor | normalize` (the GAN train chain):
    {"sc": its RandomScaleCrop, "out_hw", "mean", "std"}; None for any
    other chain."""
    parts = [p.strip() for p in str(transforms_str or "").split("|")]
    if len(parts) != 4 or parts[0] != "pil2np" or parts[2] != "totensor" \
            or parts[3] != "normalize":
        return None
    bits = parts[1].split(":")
    if bits[0] != "scalecrop" or len(bits) < 2:
        return None
    sc = RandomScaleCrop(*bits[1:])
    return {"sc": sc, "out_hw": (int(sc.size[1]), int(sc.size[0])),
            "mean": torch.tensor(mean_std[0], dtype=torch.float32),
            "std": torch.tensor(mean_std[1], dtype=torch.float32)}


def _thumbnail_hw(h, w, side):
    """The (h, w) PIL's `thumbnail((side, side))` gives an h x w image
    (Image.thumbnail's preserve_aspect_ratio, Pillow 7.1 and later)."""
    if max(h, w) <= side:
        return h, w

    def nearest(n, key):
        return max(min(math.floor(n), math.ceil(n), key=key), 1)
    aspect = w / h
    if aspect <= 1:
        return side, nearest(side * aspect,
                             key=lambda n: abs(aspect - n / side))
    return nearest(side / aspect, key=lambda n: 0 if n == 0
                   else abs(aspect - side / n)), side


class Downscale:
    """`downscale:<side>`: fit the longest side into `side`, keeping the
    aspect ratio (PIL's LANCZOS thumbnail, as the reference). A float image
    goes through uint8 by truncation, as in the JAX package."""

    def __init__(self, size):
        self.size = int(size)

    def out_shapes(self, shapes, draws):
        return [_thumbnail_hw(s[0], s[1], self.size) + tuple(s[2:])
                for s in shapes]

    def __call__(self, pic):
        if isinstance(pic, Image.Image):
            if max(pic.size) > self.size:
                pic = pic.copy()
                pic.thumbnail((self.size, self.size), Image.LANCZOS)
            return pic
        arr = _as_array(pic)
        if max(arr.shape[:2]) <= self.size:
            return pic
        img = Image.fromarray((arr * 255).astype(np.uint8))
        img.thumbnail((self.size, self.size), Image.LANCZOS)
        return torch.from_numpy(np.array(img, dtype=np.float32) / 255.0)


def _parse_tuple(tpl, dtype):
    if isinstance(tpl, str):
        return tuple(dtype(x) for x in tpl.split("_"))
    return tuple(dtype(x) for x in tpl)


# ---------------------------------------------------------------------------
# photometric transforms (photometric_transforms.py)
# ---------------------------------------------------------------------------

class ApplyClahe:
    """`apply_clahe:<clip>[:<grid>[:<space>]]`: CLAHE on the first channel
    of the normalized colorspace, back to RGB."""

    def __init__(self, clip_limit=4, grid_size=8, colorspace="lab"):
        self.clip_limit = float(clip_limit)
        self.grid_size = int(grid_size)
        self.colorspace = colorspace

    def __call__(self, pic):
        return clahe_ops.image_clahe(_as_image(pic), self.clip_limit,
                                     self.grid_size, self.colorspace)


def _space_channels(colorspace, c=3):
    return 1 if colorspace.lower() == "gray" else c


class ApplyColorspaceClahe(ApplyClahe):
    """`apply_colorspaceclahe`: as apply_clahe, staying in the normalized
    colorspace."""

    def __call__(self, pic):
        return clahe_ops.image_colorspace_clahe(
            _as_image(pic), self.clip_limit, self.grid_size, self.colorspace)

    def out_shapes(self, shapes, draws):
        return [s[:2] + (_space_channels(self.colorspace),) for s in shapes]


class CreateClahedImage(ApplyClahe):
    """`create_clahed`: one image -> [it, its apply_clahe of the first
    three channels]."""

    def joint(self, pics, draws=None):
        (pic,) = pics
        pic = _as_image(pic)
        return [pic, ApplyClahe.__call__(self, pic[:, :, :3])]

    def out_shapes(self, shapes, draws):
        (s,) = shapes
        return [s, s[:2] + (3,)]


class AddClaheFromRgb(ApplyClahe):
    """`add_clahe_fromrgb`: append the CLAHE'd first channel of the
    normalized colorspace of the first three channels."""

    def __call__(self, pic):
        pic = _as_image(pic)
        spc = cs_ops.rgb2normspace(pic[:, :, :3], self.colorspace)
        chan = clahe_ops.channel_clahe(spc[:, :, 0], self.clip_limit,
                                       self.grid_size)
        return torch.cat([pic, chan[:, :, None]], dim=-1)

    def out_shapes(self, shapes, draws):
        return [s[:2] + (s[2] + 1,) for s in shapes]


# 256 bins centred on the uint8 levels (functional.py:96-103)
HISTOGRAM_BINS = np.linspace(-0.00196078431372549, 1.0019607843137255, 257)
HISTOGRAM_CENTERS = np.linspace(0, 1, 256)


def _cdf(chan):
    return np.cumsum(np.histogram(chan, HISTOGRAM_BINS)[0]) / chan.size


def channel_histogram_matching(chan0, cdf_target):
    """Map a channel's CDF onto `cdf_target` over the 256 centres ("eq":
    equalize)."""
    cdf0 = _cdf(chan0)
    if isinstance(cdf_target, str) and cdf_target == "eq":
        return np.interp(chan0, HISTOGRAM_CENTERS,
                         cdf0 * HISTOGRAM_CENTERS[-1]).astype(np.float32)
    return np.interp(chan0, HISTOGRAM_CENTERS,
                     np.interp(cdf0, cdf_target,
                               HISTOGRAM_CENTERS)).astype(np.float32)


def channel2channel_histogram_matching(chan0, chan1):
    return np.interp(chan0, HISTOGRAM_CENTERS,
                     np.interp(_cdf(chan0), _cdf(chan1),
                               HISTOGRAM_CENTERS)).astype(np.float32)


def _apply_lightness(img, colorspace, func):
    """func (numpy) on the first channel of the normalized colorspace,
    back to RGB."""
    spc = cs_ops.rgb2normspace(_as_image(img), colorspace).numpy().copy()
    spc[:, :, 0] = func(spc[:, :, 0])
    return cs_ops.normspace2rgb(torch.from_numpy(spc), colorspace)


def _target_cdf(histogram):
    if histogram == "eq":
        return histogram
    from gandtr_tpu_torch.data.histogram_consts import HISTOGRAM_CDF
    return HISTOGRAM_CDF[histogram]


class MatchHistogram:
    """`match_histogram:<name|eq>[:<space>]`: the lightness histogram
    matched to a stored one (data/histogram_consts.py) or equalized."""

    def __init__(self, histogram, colorspace="lab"):
        self.histogram = histogram
        self.colorspace = colorspace

    def __call__(self, pic):
        cdf = _target_cdf(self.histogram)
        return _apply_lightness(
            pic, self.colorspace,
            lambda c: channel_histogram_matching(c, cdf))


class ReplaceChannelWithHistogram:
    """`replace_histogram:<name|eq>:<append|replace>`: with two images,
    the first image's last channel matched to the second's, which loses
    its last channel (training); with one (or more than two), matched to
    a stored histogram, the others unchanged (test). `replace` drops the
    first image's last channel before appending the matched one
    (photometric_transforms.py:67-87)."""

    def __init__(self, histogram, created_channel):
        if created_channel not in {"append", "replace"}:
            raise ValueError("created_channel %r" % created_channel)
        self.histogram = histogram
        self.created_channel = created_channel

    def joint(self, pics, draws=None):
        pic0, rest = _as_array(pics[0]), list(pics[1:])
        out0 = pic0[:, :, :-1] if self.created_channel == "replace" else pic0
        if len(rest) == 1:
            pic1 = _as_array(rest[0])
            chan = channel2channel_histogram_matching(pic0[:, :, -1],
                                                      pic1[:, :, -1])
            return [_to_tensor(np.concatenate((out0, chan[:, :, None]), 2)),
                    _to_tensor(pic1[:, :, :-1])]
        chan = channel_histogram_matching(pic0[:, :, -1],
                                          _target_cdf(self.histogram))
        return [_to_tensor(np.concatenate((out0, chan[:, :, None]), 2))] \
            + rest

    def out_shapes(self, shapes, draws):
        grown = 0 if self.created_channel == "replace" else 1
        first = shapes[0][:2] + (shapes[0][2] + grown,)
        if len(shapes) == 2:
            return [first, shapes[1][:2] + (shapes[1][2] - 1,)]
        return [first] + shapes[1:]


class GammaEqualize:
    """`gamma_equalize:<target>[:<space>]`: the gamma that brings the
    lightness mean to `target` (Newton's method, clipped to [0.1, 10];
    functional.py:116-130)."""

    def __init__(self, target, colorspace="lab"):
        self.target = float(target)
        self.colorspace = colorspace
        if not 0 < self.target < 1:
            raise ValueError("gamma_equalize target %s outside (0, 1)"
                             % self.target)

    def _match(self, channel):
        import warnings

        import scipy.optimize
        target = self.target

        def func(gamma):
            return np.mean(np.power(channel, gamma)) - target

        x0 = np.log(target) / np.log(np.mean(channel))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                sol = scipy.optimize.newton(func, x0=x0, tol=1e-4,
                                            maxiter=50)
            except RuntimeError:
                sol = 0.1 if abs(func(0.1)) < abs(func(10)) else 10
        return np.power(channel, np.clip(sol, 0.1, 10))

    def __call__(self, pic):
        return _apply_lightness(pic, self.colorspace, self._match)


# ---------------------------------------------------------------------------
# channel transforms (channel_transforms.py)
# ---------------------------------------------------------------------------

class AddConstantChannel:
    """`add_const:<value>`: append a constant channel."""

    def __init__(self, value):
        self.value = float(value)

    def __call__(self, pic):
        pic = _as_image(pic)
        return torch.cat([pic, torch.full(tuple(pic.shape[:2]) + (1,),
                                          self.value, dtype=torch.float32)],
                         dim=-1)

    def out_shapes(self, shapes, draws):
        return [s[:2] + (s[2] + 1,) for s in shapes]


class NpInvertChannel:
    """`np_invert_chan:<c>`: channel c -> 1 - channel c."""

    def __init__(self, channel):
        self.channel = int(channel)

    def __call__(self, pic):
        arr = _as_array(pic).copy()
        arr[:, :, self.channel] = 1.0 - arr[:, :, self.channel]
        return _to_tensor(arr)


def _slice_end(end):
    return int(end) if end and end not in ("unset", "null") else None


class NpChanSelector:
    """`np_chanselect:<start>[:<end>]`: keep the channel slice [start,
    end) (an absent end keeps the rest)."""

    def __init__(self, start, end="unset"):
        self.start, self.end = int(start), _slice_end(end)

    def __call__(self, pic):
        return _to_tensor(_as_array(pic)[:, :, self.start:self.end])

    def out_shapes(self, shapes, draws):
        return [s[:2] + (_slice_len(s[2], self.start, self.end),)
                for s in shapes]


class NpCloneChannels:
    """`np_chanclone:<start>[:<end>]`: append a copy of the channel slice
    [start, end), or of channel `start` alone when no end is given."""

    def __init__(self, start, end="unset"):
        self.start = int(start)
        self.end = "unset" if end == "unset" else _slice_end(end)

    def _stop(self):
        return self.start + 1 if self.end == "unset" else self.end

    def __call__(self, pic):
        arr = _as_array(pic)
        return _to_tensor(np.concatenate(
            (arr, arr[:, :, self.start:self._stop()]), axis=2))

    def out_shapes(self, shapes, draws):
        return [s[:2] + (s[2] + _slice_len(s[2], self.start, self._stop()),)
                for s in shapes]


class AddIntensityFromRgb:
    """`add_intensity_fromrgb[:<space>]`: append the lightness (the first
    channel of the normalized colorspace of the first three channels; not
    cv2's gray)."""

    def __init__(self, colorspace="lab"):
        self.colorspace = colorspace

    def __call__(self, pic):
        pic = _as_image(pic)
        spc = cs_ops.rgb2normspace(pic[:, :, :3], self.colorspace)
        return torch.cat([pic, spc[:, :, :1]], dim=-1)

    def out_shapes(self, shapes, draws):
        return [s[:2] + (s[2] + 1,) for s in shapes]


class ToColorspace:
    """`tospace:<space>`: the normalized colorspace of the first three
    channels."""

    def __init__(self, colorspace):
        self.colorspace = colorspace

    def __call__(self, pic):
        return cs_ops.rgb2normspace(_as_image(pic)[:, :, :3],
                                    self.colorspace)

    def out_shapes(self, shapes, draws):
        return [s[:2] + (_space_channels(self.colorspace),) for s in shapes]


TRANSFORMS = {
    "totensor": ToTensor,
    "normalize": Normalize,
    "pil2np": Pil2Numpy,
    "stackbatch": StackBatch,
    "nan_check": NanCheck,

    "random_crop": RandomCrop,
    "mirror": RandomHorizontalFlip,
    "center_crop": CenterCrop,
    "square_crop": SquareCrop,
    "downscale": Downscale,
    "scalecrop": RandomScaleCrop,
    "centerscalecrop": CenterScaleCrop,
    "gaussian_noise": AdditiveGaussianNoise,

    "add_const": AddConstantChannel,
    "tospace": ToColorspace,
    "add_intensity_fromrgb": AddIntensityFromRgb,
    "np_invert_chan": NpInvertChannel,
    "np_chanselect": NpChanSelector,
    "np_chanclone": NpCloneChannels,

    "add_clahe_fromrgb": AddClaheFromRgb,
    "apply_clahe": ApplyClahe,
    "apply_colorspaceclahe": ApplyColorspaceClahe,
    "create_clahed": CreateClahedImage,
    "match_histogram": MatchHistogram,
    "replace_histogram": ReplaceChannelWithHistogram,
    "gamma_equalize": GammaEqualize,
}


def initialize_transforms(augmentations, mean_std):
    """Parse the pipe-DSL into a Compose; `normalize` receives mean_std."""
    trans = []
    for aug in [x.strip() for x in augmentations.split("|") if x.strip()]:
        tname, *args = aug.split(":", 1)
        args = args[0].split(":") if args else []
        if tname == "normalize":
            args = list(mean_std) + args
        trans.append(TRANSFORMS[tname](*args))
    return Compose(trans)


def split_device_transform(transforms_str, mean_std):
    """Split `pil2np [| apply_clahe:...] | totensor | normalize` into
    (host_fn, device_fn): `host_fn(PIL) -> uint8 (H, W, 3)` array (decode
    only), and `device_fn((N, H, W, 3) float32 in [0, 1], mask=None) ->
    normalized`, which runs CLAHE and (x - mean) / std on the tensor's
    device; with `mask` (N, H, W) of a padded bucket, CLAHE takes each
    image's valid rectangle (ops/clahe.py::image_clahe_masked).
    Returns (None, None) for any other pipeline."""
    parts = [x.strip() for x in str(transforms_str).split("|") if x.strip()]
    if len(parts) < 3 or parts[0] != "pil2np" or parts[-1] != "normalize":
        return None, None
    mid = parts[1:-1]
    if not mid or mid[-1] != "totensor":
        return None, None
    mid = mid[:-1]
    clahe_args = None
    if len(mid) == 1 and mid[0].split(":")[0] == "apply_clahe":
        bits = mid[0].split(":")[1:]
        clahe_args = (float(bits[0]) if bits else 4.0,
                      int(bits[1]) if len(bits) > 1 else 8,
                      bits[2] if len(bits) > 2 else "lab")
    elif mid:
        return None, None
    mean = torch.tensor(mean_std[0], dtype=torch.float32)
    std = torch.tensor(mean_std[1], dtype=torch.float32)

    def host_fn(pic):
        if isinstance(pic, Image.Image):
            return np.asarray(pic.convert("RGB"))
        return np.asarray(pic)

    def device_fn(x, mask=None):
        if clahe_args is not None:
            if mask is None:
                x = clahe_ops.image_clahe(x, *clahe_args)
            else:
                # padded bucket: each image's CLAHE on its valid rectangle
                from gandtr_tpu_torch.ops.maskprop import MaskState
                one = x.dim() == 3
                hw = MaskState.maybe(mask[None] if one else mask).hw_tensor()
                x = clahe_ops.image_clahe_masked(x[None] if one else x, hw,
                                                 *clahe_args)
                x = x[0] if one else x
        return (x - mean.to(x.device)) / std.to(x.device)

    return host_fn, device_fn


def device_quantize_rgb(y, mean_std):
    """Denormalize a generator output and truncate it to uint8 RGB on its
    device, in float32: floor(clip(y * std + mean, 0, 1) * 255)."""
    mean = torch.tensor(mean_std[0], dtype=torch.float32, device=y.device)
    std = torch.tensor(mean_std[1], dtype=torch.float32, device=y.device)
    rgb = torch.clamp(y.float() * std + mean, 0.0, 1.0)
    return torch.floor(rgb * 255.0).to(torch.uint8)
