"""Image utilities: normalized images back to RGB, and image grids
(counterpart of gandtr_tpu/utils/imgtools.py; the reference's
mdir/tools/imgtools.py), on numpy arrays, with the colorspace undo of
ops/colorspace.py."""
import numpy as np
import torch

from gandtr_tpu_torch.ops import colorspace as cs


def unnormalize(img, mean_std=((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
                colorspace="rgb", stretch=None):
    """(H, W, C) normalized float -> RGB float in [0, 1]
    (imgtools.py:13-72): the first three channels of a composite, the mean
    and std undone, clipped (or stretched by `minmax`), a normalized
    colorspace turned back into RGB, one channel repeated thrice."""
    mean = np.asarray(mean_std[0], np.float32)
    std = np.asarray(mean_std[1], np.float32)
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] > 3:
        img = img[..., :3]
    c = img.shape[-1]
    img = img * std[:c] + mean[:c]
    if stretch == "minmax":
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    elif stretch == "clip" or stretch is None:
        img = np.clip(img, 0, 1)
    if colorspace != "rgb" and c == 3:
        img = cs.normspace2rgb(torch.from_numpy(np.ascontiguousarray(img)),
                               colorspace).numpy()
        img = np.clip(img, 0, 1)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def to_uint8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def image_grid(images, cols=None, pad=2, pad_value=1.0):
    """Equally sized (H, W, C) float images in one grid image, row by row
    (imgtools.py:75-105)."""
    n = len(images)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h, w, c = images[0].shape
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, c),
                   pad_value, np.float32)
    for i, img in enumerate(images):
        r, cc = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h,
             cc * (w + pad):cc * (w + pad) + w] = img
    return grid
