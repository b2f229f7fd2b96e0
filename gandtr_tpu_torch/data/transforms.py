"""Preprocessing with the reference's transform DSL (counterpart of
gandtr_tpu/data/transforms.py), for the descriptor pipeline
`pil2np | apply_clahe:<clip>[:<grid>[:<space>]] | totensor | normalize`.

The host transforms work on one image at a time: PIL image or uint8 array
in, (H, W, 3) float32 CPU tensor out (NHWC like the JAX package; CLAHE runs
its plain version there). `split_device_transform` gives the same
preprocessing as a batch function on the tensor's device, where CLAHE is
one launch of the K1 kernel for the whole batch. The generators'
pipeline `pil2np | totensor | normalize` splits the same way (no CLAHE),
and `device_quantize_rgb` turns a generator's output back into uint8 RGB.
"""
import numpy as np
import torch
from PIL import Image

from gandtr_tpu_torch.ops import clahe as clahe_ops


# the host transforms' random draws, reseeded each epoch (the reference's
# per-epoch seed); the ported transforms draw nothing yet
_RNG = np.random.RandomState(0)


def seed_transforms(seed):
    """Reseed the host transforms' random draws for an epoch."""
    global _RNG
    _RNG = np.random.RandomState(seed)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, pic):
        for t in self.transforms:
            pic = t(pic)
        return pic


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


TRANSFORMS = {
    "pil2np": Pil2Numpy,
    "apply_clahe": ApplyClahe,
    "totensor": ToTensor,
    "normalize": Normalize,
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
