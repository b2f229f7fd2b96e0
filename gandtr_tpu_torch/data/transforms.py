"""Preprocessing with the reference's transform DSL (counterpart of
gandtr_tpu/data/transforms.py), for the descriptor pipeline
`pil2np | apply_clahe:<clip>[:<grid>[:<space>]] | totensor | normalize`
and the GAN pipelines `pil2np | scalecrop:<w>_<h>:<lo>_<hi> | totensor |
normalize` (training pairs) and `pil2np | downscale:<side> | totensor |
normalize` (visual validation). `DeviceScalecrop` is the scalecrop chain's
host half when its resize runs on the device (`device_scalecrop`).

A Compose takes one image or several (`compose(x, y)` -> [x', y']): a
random transform draws once for all of them, as the reference's variadic
transforms do, so the two images of a domain pair are cut alike. Its draws
come from the module's RNG, reseeded each epoch (`seed_transforms`), in the
JAX package's order. `Compose.draw(sizes)` makes an item's draws ahead of
its decoding: the loader calls it for its items in order on one thread, so
a thread pool decodes them in any order and each item still gets the draws
the sequential loop would give it.

The host transforms work on one image at a time: PIL image or uint8 array
in, (H, W, 3) float32 CPU tensor out (NHWC like the JAX package; CLAHE runs
its plain version there). `split_device_transform` gives the same
preprocessing as a batch function on the tensor's device, where CLAHE is
one launch of the K1 kernel for the whole batch. The generators'
pipeline `pil2np | totensor | normalize` splits the same way (no CLAHE),
and `device_quantize_rgb` turns a generator's output back into uint8 RGB.
"""
import threading

import numpy as np
import torch
from PIL import Image

from gandtr_tpu_torch.ops import clahe as clahe_ops


# the host transforms' random draws, reseeded each epoch (the reference's
# per-epoch seed)
_RNG = np.random.RandomState(0)
_RNG_LOCK = threading.Lock()


def seed_transforms(seed):
    """Reseed the host transforms' random draws for an epoch."""
    global _RNG
    _RNG = np.random.RandomState(seed)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, *pics, draws=None):
        """One image -> one; several -> a list. `draws` (from `draw`)
        replaces the random transforms' own draws."""
        out = list(pics)
        for i, t in enumerate(self.transforms):
            if hasattr(t, "joint"):
                out = t.joint(out, None if draws is None else draws[i])
            else:
                out = [t(p) for p in out]
        return out[0] if len(pics) == 1 else out

    def draw(self, sizes):
        """The random draws of this chain for images of `sizes` [(h, w),
        ...]: a list with an entry per transform (None where it draws
        nothing)."""
        out, resized = [], False
        for t in self.transforms:
            if hasattr(t, "draw"):
                if resized:
                    raise NotImplementedError(
                        "a random transform after a resizing one")
                out.append(t.draw(sizes))
            else:
                out.append(None)
                resized = resized or isinstance(t, Downscale)
        return out


class Pil2Numpy:
    """PIL image or uint8 array -> float32 (H, W, C) in [0, 1]."""

    def __call__(self, pic):
        if isinstance(pic, Image.Image):
            pic = np.asarray(pic.convert("RGB"))
        elif not isinstance(pic, np.ndarray):
            raise ValueError("Unsupported type '%s'" % type(pic))
        if pic.dtype == np.uint8:
            pic = pic.astype(np.float32) / 255.0
        return torch.from_numpy(np.ascontiguousarray(pic, np.float32))


class ToTensor:
    """Layout stays HWC (the public layout); float32, contiguous."""

    def __call__(self, pic):
        return torch.as_tensor(pic, dtype=torch.float32).contiguous()


class Normalize:
    def __init__(self, mean, std):
        self.mean = torch.tensor(mean, dtype=torch.float32)
        self.std = torch.tensor(std, dtype=torch.float32)

    def __call__(self, pic):
        return (pic - self.mean.to(pic.device)) / self.std.to(pic.device)


class ApplyClahe:
    def __init__(self, clip_limit=4, grid_size=8, colorspace="lab"):
        self.clip_limit = float(clip_limit)
        self.grid_size = int(grid_size)
        self.colorspace = colorspace

    def __call__(self, pic):
        return clahe_ops.image_clahe(pic, self.clip_limit, self.grid_size,
                                     self.colorspace)


def _as_array(pic):
    return pic.numpy() if isinstance(pic, torch.Tensor) else np.asarray(pic)


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

    def _min_size(self, sizes):
        if len(sizes) == 1 or sizes[0] == sizes[1]:
            if (np.asarray(sizes[0]) == self.size[::-1]).all():
                return None
        return np.min(np.asarray(sizes), axis=0)

    def draw(self, sizes):
        """(offset, cropped size) for images of `sizes`, or None."""
        mn = self._min_size([tuple(s) for s in sizes])
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
        if draws is None:
            return [torch.from_numpy(np.ascontiguousarray(p)) for p in pics]
        (y, x), (ch, cw) = draws
        w, h = self.size
        return [torch.from_numpy(resize_linear(p[y:y + ch, x:x + cw], w, h))
                for p in pics]

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


class Downscale:
    """`downscale:<side>`: fit the longest side into `side`, keeping the
    aspect ratio (PIL's LANCZOS thumbnail, as the reference). A float image
    goes through uint8 by truncation, as in the JAX package."""

    def __init__(self, size):
        self.size = int(size)

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


TRANSFORMS = {
    "pil2np": Pil2Numpy,
    "apply_clahe": ApplyClahe,
    "totensor": ToTensor,
    "normalize": Normalize,
    "scalecrop": RandomScaleCrop,
    "downscale": Downscale,
}


def initialize_transforms(augmentations, mean_std):
    """Parse the pipe-DSL into a Compose; `normalize` receives mean_std."""
    trans = []
    for aug in [x.strip() for x in augmentations.split("|") if x.strip()]:
        tname, *args = aug.split(":", 1)
        args = args[0].split(":") if args else []
        if tname not in TRANSFORMS:
            raise NotImplementedError("transform %r is not ported yet" % tname)
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
