"""The port's CLAHE (gandtr_tpu_torch/ops/clahe.py, plain version of K1) and
LAB colorspace against the JAX package and cv2, on the CPU."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.ops import clahe as jclahe
from gandtr_tpu.ops import colorspace as jcs
from gandtr_tpu.ops.clahe_pallas import clahe_u8_pallas
from gandtr_tpu_torch.ops import clahe as tclahe
from gandtr_tpu_torch.ops import colorspace as tcs

torch.set_num_threads(1)


def _img(shape, seed=7):
    return (np.random.RandomState(seed).rand(*shape) * 256).astype(np.uint8)


# the shapes and settings of tests/test_clahe_pallas.py (interpret mode is
# slow, so they stay small)
@pytest.mark.parametrize("clip,grid,shape", [
    (1.0, 4, (32, 32)),
    (4.0, 4, (29, 35)),
])
def test_plain_equals_jax_pallas_interpret(clip, grid, shape):
    img = _img(shape)
    want = np.asarray(clahe_u8_pallas(jnp.asarray(img), clip, (grid, grid),
                                      interpret=True))
    got = tclahe.clahe_u8(torch.from_numpy(img), clip, (grid, grid)).numpy()
    np.testing.assert_array_equal(got, want)


# (64, 48) divides on both axes, (37, 53) and (200, 301) on neither,
# (64, 53) on one axis only: cv2 then pads a whole extra tile on the other
@pytest.mark.parametrize("shape", [(64, 48), (37, 53), (200, 301), (64, 53)])
def test_plain_equals_jax_and_cv2(shape):
    img = _img(shape, seed=shape[0])
    got = tclahe.clahe_u8(torch.from_numpy(img), 1.0, (8, 8)).numpy()
    # eager, as the JAX package's own cv2 test runs it: XLA's CPU jit
    # contracts the lerp into FMAs, which flips round-half-even ties
    with jax.disable_jit():
        want = np.asarray(jclahe.clahe_u8(jnp.asarray(img), 1.0, (8, 8)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, cv2.createCLAHE(clipLimit=1.0, tileGridSize=(8, 8)).apply(img))


def test_batch_equals_per_image():
    """One call on (N, H, W) equals N calls on (H, W): the kernel takes a
    whole batch in one launch pair, and so does the plain version."""
    batch = np.stack([_img((37, 53), seed=s) for s in range(3)])
    got = tclahe.clahe_u8(torch.from_numpy(batch), 1.0, 8).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], cv2.createCLAHE(1.0, (8, 8)).apply(batch[i]))


def test_lab_roundtrip_matches_jax():
    rgb = np.random.RandomState(1).rand(37, 53, 3).astype(np.float32)
    spc_j = np.asarray(jcs.rgb2normspace(jnp.asarray(rgb), "lab"))
    spc_t = tcs.rgb2normspace(torch.from_numpy(rgb), "lab").numpy()
    # pow(1/3) in place of cbrt, and summation order: float32 ulps
    np.testing.assert_allclose(spc_t, spc_j, atol=1e-6, rtol=0)
    back_j = np.asarray(jcs.normspace2rgb(jnp.asarray(spc_j), "lab"))
    back_t = tcs.normspace2rgb(torch.from_numpy(spc_j.copy()), "lab").numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-6, rtol=0)
    assert back_t.min() >= 0.0 and back_t.max() <= 1.0


def test_image_clahe_matches_jax():
    """LAB-CLAHE of a float RGB image (JAX eager, as above). The lightness
    is truncated to uint8 (`* 255`, then a truncating cast); where the
    port's and JAX's LAB differ by an ulp across an integer, that u8 value,
    and so the CLAHE lightness, can differ by one step. (A scratch check
    found the LAB lightness within 1.2e-7 and no such flip over 65k
    pixels.) So at most 0.1% of pixels may differ, each by at most 1/255,
    and the RGB result agrees to float32 noise wherever they do not."""
    rgb = np.random.RandomState(3).rand(64, 80, 3).astype(np.float32)
    with jax.disable_jit():
        L_j = jcs.rgb2normspace(jnp.asarray(rgb), "lab")[..., 0]
        cl_j = np.asarray(jclahe.channel_clahe(L_j, 1.0, 8))
        want = np.asarray(jclahe.image_clahe(jnp.asarray(rgb), 1.0, 8, "lab"))
    L_t = tcs.rgb2normspace(torch.from_numpy(rgb), "lab")[..., 0]
    cl_t = tclahe.channel_clahe(L_t, 1.0, 8).numpy()
    got = tclahe.image_clahe(torch.from_numpy(rgb), 1.0, 8, "lab").numpy()
    flips = np.abs(cl_t - cl_j)
    assert (flips > 0).mean() <= 1e-3
    assert flips.max() <= 1.0 / 255 + 1e-7
    same = flips == 0
    np.testing.assert_allclose(got[same], want[same], atol=1e-5, rtol=0)
