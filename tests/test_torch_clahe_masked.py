"""The port's masked CLAHE (gandtr_tpu_torch/ops/clahe.py::
clahe_u8_masked_plain, the plain version of K4 with its LUT build) against
the JAX package's masked CLAHE and cv2, on the CPU: each image's valid
rectangle of a padded bucket, as cv2 computes it on the exact crop."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.ops import clahe as jclahe
from gandtr_tpu.ops import clahe_pallas as jcp
from gandtr_tpu_torch.kernels import clahe_masked as kmasked
from gandtr_tpu_torch.ops import clahe as tclahe

torch.set_num_threads(1)

# rectangles as imresize(., 362) leaves them in the fine-tune's 364 bucket,
# and two small images
RECTS = [(362, 241), (272, 362), (362, 362), (362, 203), (300, 362),
         (41, 57), (29, 35)]
BUCKET = 364
SETTINGS = [(1.0, 8), (4.0, 8), (1.0, 4), (4.0, 4)]


def _batch(rects, bucket, seed=0):
    """Padded uint8 bucket (N, B, B), zero band, and hw (N, 2) int32. Each
    image is smooth content plus noise, so some bins clip and some not."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((len(rects), bucket, bucket), np.uint8)
    for i, (h, w) in enumerate(rects):
        yy, xx = np.mgrid[:h, :w]
        base = (yy * (3 + i) + xx * (5 - i)) % 97 + 60
        imgs[i, :h, :w] = np.clip(base + rng.randint(-40, 40, (h, w)), 0,
                                  255)
    return imgs, np.asarray(rects, np.int32)


@pytest.mark.parametrize("clip,grid", SETTINGS)
def test_plain_equals_cv2_on_the_exact_crop(clip, grid):
    imgs, hw = _batch(RECTS, BUCKET)
    got = tclahe.clahe_u8_masked(torch.from_numpy(imgs), torch.from_numpy(hw),
                                 clip, grid).numpy()
    cl = cv2.createCLAHE(clipLimit=clip, tileGridSize=(grid, grid))
    for i, (h, w) in enumerate(RECTS):
        np.testing.assert_array_equal(got[i, :h, :w],
                                      cl.apply(imgs[i, :h, :w]))
        assert not got[i, h:].any() and not got[i, :, w:].any()


@pytest.mark.parametrize("clip,grid", SETTINGS)
def test_plain_equals_jax_gather_form(clip, grid):
    """Against the JAX package's `clahe_u8_masked(interp="gather")`, run
    eagerly as its own tests run it (XLA's CPU jit contracts the lerp into
    FMAs), bit for bit on each valid rectangle."""
    imgs, hw = _batch(RECTS, BUCKET, seed=1)
    got = tclahe.clahe_u8_masked_plain(torch.from_numpy(imgs),
                                       torch.from_numpy(hw), clip,
                                       (grid, grid)).numpy()
    for i, (h, w) in enumerate(RECTS):
        want = np.asarray(jclahe.clahe_u8_masked(
            jnp.asarray(imgs[i]), (jnp.int32(h), jnp.int32(w)), clip,
            (grid, grid), interp="gather"))
        np.testing.assert_array_equal(got[i, :h, :w], want[:h, :w])


def test_small_rect_in_small_bucket_equals_cv2_and_jax_kernel():
    """41x57 in a 64x64 bucket (tests/test_clahe_pallas.py:38-44): bit-equal
    to cv2, and within the JAX K4 interpret mode's tie class (its lerp runs
    under XLA's CPU FMA contraction: at most 1 level on under 0.5% of the
    pixels, tests/test_clahe_pallas.py:58-60)."""
    h, w = 41, 57
    img = np.zeros((64, 64), np.uint8)
    img[:h, :w] = np.random.RandomState(0).randint(0, 256, (h, w), np.uint8)
    got = tclahe.clahe_u8_masked(torch.from_numpy(img[None]),
                                 torch.tensor([[h, w]], dtype=torch.int32),
                                 4.0, 8)[0].numpy()
    np.testing.assert_array_equal(
        got[:h, :w], cv2.createCLAHE(4.0, (8, 8)).apply(img[:h, :w]))
    orig = jcp.masked_interp_pallas
    jcp.masked_interp_pallas = lambda *a, **k: orig(*a, interpret=True, **k)
    try:
        ref = np.asarray(jclahe.clahe_u8_masked(
            jnp.asarray(img), (jnp.int32(h), jnp.int32(w)), 4.0, (8, 8),
            interp="pallas"))
    finally:
        jcp.masked_interp_pallas = orig
    d = np.abs(got[:h, :w].astype(int) - ref[:h, :w].astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.005, (d.max(), (d > 0).mean())


def test_image_clahe_masked_equals_exact_crop():
    """The LAB form on a padded RGB batch equals the unmasked port on each
    exact crop (the colour conversions are per pixel). To 1e-6, not bit for
    bit: torch's CPU kernels run a row's vectorised body and its scalar
    tail through different math routines, and the crop's rows split
    differently from the bucket's (measured 3e-7)."""
    rng = np.random.RandomState(3)
    rects = [(30, 26), (26, 30), (19, 32)]
    x = np.zeros((3, 32, 32, 3), np.float32)
    for i, (h, w) in enumerate(rects):
        x[i, :h, :w] = rng.rand(h, w, 3)
    got = tclahe.image_clahe_masked(torch.from_numpy(x),
                                    torch.tensor(rects, dtype=torch.int32),
                                    1.0, 8).numpy()
    for i, (h, w) in enumerate(rects):
        want = tclahe.image_clahe(torch.from_numpy(x[i:i + 1, :h, :w]),
                                  1.0, 8).numpy()[0]
        np.testing.assert_allclose(got[i, :h, :w], want, rtol=0, atol=1e-6)


def test_device_transform_with_a_mask_matches_jax():
    """`split_device_transform`'s device half with a padded-bucket mask (the
    descriptor pipeline `pil2np | apply_clahe:1.0 | totensor | normalize`)
    against the JAX package's, run eagerly (its `lax.map` body compiled
    under XLA's CPU jit contracts multiply-adds), on each valid rectangle;
    the port zeroes nothing itself, so the band is left out. Within 1e-5
    relative: the LAB conversions' float32 powers come from two libraries
    (6e-6 measured), while one uint8 CLAHE level would move a value by
    0.017."""
    import jax
    from gandtr_tpu.data.transforms import split_device_transform as jsplit
    from gandtr_tpu_torch.data.transforms import split_device_transform
    spec = "pil2np | apply_clahe:1.0 | totensor | normalize"
    mean_std = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
    rng = np.random.RandomState(4)
    rects = [(30, 26), (26, 30), (19, 32)]
    x = np.zeros((3, 32, 32, 3), np.float32)
    mask = np.zeros((3, 32, 32), np.float32)
    for i, (h, w) in enumerate(rects):
        x[i, :h, :w] = rng.rand(h, w, 3)
        mask[i, :h, :w] = 1.0
    got = split_device_transform(spec, mean_std)[1](
        torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    with jax.disable_jit():
        want = np.asarray(jsplit(spec, mean_std)[1](jnp.asarray(x),
                                                    mask=jnp.asarray(mask)))
    for i, (h, w) in enumerate(rects):
        np.testing.assert_allclose(got[i, :h, :w], want[i, :h, :w],
                                   rtol=1e-5, atol=1e-5)


def test_wrapper_takes_cuda_tensors_only():
    """ops/clahe.py picks the plain version for a CPU tensor; K4's wrapper
    raises on it and counts no launch."""
    before = kmasked.LAUNCHES
    img = torch.zeros((2, 16, 16), dtype=torch.uint8)
    hw = torch.tensor([[16, 12], [9, 16]], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmasked.clahe_u8_masked_cuda(img, hw, 1.0, 8)
    assert tclahe.clahe_u8_masked(img, hw, 1.0, 8).shape == img.shape
    assert kmasked.LAUNCHES == before
