"""The port's colorspaces (gandtr_tpu_torch/ops/colorspace.py) and its
CLAHE in them (ops/clahe.py, the plain versions of K1 and K4) against the
JAX package, on the CPU.

- `rgb2normspace` / `normspace2rgb` in every space and its `s` form:
  1e-6, hue channels 1e-5; gray and bgr have no way back in either
  package, and an unknown space raises in both.
- `image_clahe`, `image_colorspace_clahe`, `image_clahe_masked` and the
  `add_clahe_fromrgb` transform in luv, lsh and hsv. The lightness is
  truncated to uint8 (`* 255`, then a truncating cast), so an ulp of the
  space's first channel can move one uint8 level: at most 0.1% of the
  CLAHE'd lightness values may differ, each by one level, and the rest
  agrees to 1e-5 (as tests/test_torch_clahe.py holds lab). JAX runs
  eagerly (XLA's CPU jit contracts FMAs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.data import transforms as jT
from gandtr_tpu.ops import clahe as jclahe
from gandtr_tpu.ops import colorspace as jcs
from gandtr_tpu_torch.data import transforms as tT
from gandtr_tpu_torch.ops import clahe as tclahe
from gandtr_tpu_torch.ops import colorspace as tcs

torch.set_num_threads(1)

SPACES = ["lab", "luv", "lsh", "hsv", "yxz", "gray", "bgr", "rgb"]
# the hue channel's index in each space's normalized form
HUE = {"lsh": 2, "hsv": 0}
CLAHE_SPACES = ["luv", "lsh", "hsv"]


def _rgb(shape=(37, 53), seed=0):
    """Random RGB with the awkward pixels in it: grays (achromatic: max ==
    min), black, white, a max shared by two channels, uint8 levels."""
    rs = np.random.RandomState(seed)
    img = rs.uniform(0, 1, shape + (3,)).astype(np.float32)
    img[:4, :4] = 0.5
    img[4:8, :4] = 0.0
    img[8:12, :4] = 1.0
    img[12:16, :4] = np.float32([0.7, 0.7, 0.2])
    img[16:20, :4] = np.float32([0.2, 0.7, 0.7])
    img[20:, :6] = rs.randint(0, 256, (shape[0] - 20, 6, 3)) / np.float32(255)
    return img


def _base(space):
    return space[1:] if len(space) == 4 and space[0] == "s" else space


def _tol(space, c):
    return 1e-5 if HUE.get(_base(space)) == c else 1e-6


@pytest.mark.parametrize("space", SPACES + ["s" + s for s in SPACES
                                            if s != "gray"])
def test_normspace_both_ways_equal_jax(space):
    img = _rgb()
    with jax.disable_jit():
        want = np.asarray(jcs.rgb2normspace(jnp.asarray(img), space))
    got = tcs.rgb2normspace(torch.from_numpy(img), space).numpy()
    assert got.shape == want.shape
    for c in range(got.shape[-1]):
        np.testing.assert_allclose(got[..., c], want[..., c],
                                   atol=_tol(space, c), rtol=0)
    base = _base(space)
    if base in ("gray", "bgr"):
        with pytest.raises(NotImplementedError):
            jcs.normspace2rgb(jnp.asarray(want), space)
        with pytest.raises(NotImplementedError):
            tcs.normspace2rgb(torch.from_numpy(want.copy()), space)
        return
    with jax.disable_jit():
        back_j = np.asarray(jcs.normspace2rgb(jnp.asarray(want), space))
    back_t = tcs.normspace2rgb(torch.from_numpy(want.copy()), space).numpy()
    # a negative linear value to the power 1/2.2 is NaN in both (syxz)
    np.testing.assert_array_equal(np.isnan(back_t), np.isnan(back_j))
    np.testing.assert_allclose(back_t, back_j, atol=1e-6, rtol=0)
    if base in ("lab", "luv"):
        assert back_t.min() >= 0.0 and back_t.max() <= 1.0
    if base in ("lsh", "hsv", "yxz", "rgb") and space == base:
        np.testing.assert_allclose(back_t, img, atol=2e-6, rtol=0)


def test_unknown_space_raises_in_both():
    img = _rgb((24, 8))
    for fn in (jcs.rgb2normspace, jcs.normspace2rgb):
        with pytest.raises(NotImplementedError):
            fn(jnp.asarray(img), "cmyk")
    for fn in (tcs.rgb2normspace, tcs.normspace2rgb):
        with pytest.raises(NotImplementedError):
            fn(torch.from_numpy(img), "cmyk")


def test_hue_at_the_wrap_and_at_achromatic_pixels():
    """Hue near 360 (red with a little blue) and at max == min follows the
    JAX formula, not cv2's rounding of it: equal to float32 noise, and 0
    at gray pixels."""
    rs = np.random.RandomState(5)
    img = np.stack([np.ones(500, np.float32),
                    rs.uniform(0, 0.01, 500).astype(np.float32),
                    rs.uniform(0, 0.02, 500).astype(np.float32)], -1)
    img = np.concatenate([img, np.full((20, 3), 0.25, np.float32)])[None]
    for space in ("hsv", "lsh"):
        with jax.disable_jit():
            want = np.asarray(jcs.rgb2normspace(jnp.asarray(img), space))
        got = tcs.rgb2normspace(torch.from_numpy(img), space).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert (got[0, -20:, HUE[space]] == 0).all()


def _held(got_l, want_l, got, want, atol=1e-5):
    """The CLAHE'd lightness within one level on at most 0.1% of values;
    the whole output within `atol` wherever the lightness agrees."""
    flips = np.abs(got_l - want_l)
    assert (flips > 0).mean() <= 1e-3, (flips > 0).mean()
    assert flips.max() <= 1.0 / 255 + 1e-7
    same = flips == 0
    np.testing.assert_allclose(got[same], want[same], atol=atol, rtol=0)


def _lightness_clahe(space, img, hw=None):
    """Both packages' CLAHE'd uint8 lightness, as floats."""
    with jax.disable_jit():
        L_j = jcs.rgb2normspace(jnp.asarray(img), space)[..., 0]
        if hw is None:
            want = np.asarray(jclahe.channel_clahe(L_j, 1.0, 8))
        else:
            want = np.asarray(jclahe.channel_clahe_masked(L_j, hw, 1.0, 8))
    L_t = tcs.rgb2normspace(torch.from_numpy(img), space)[..., 0]
    if hw is None:
        got = tclahe.channel_clahe(L_t, 1.0, 8).numpy()
    else:
        got = tclahe.channel_clahe_masked(
            L_t[None], torch.tensor([hw], dtype=torch.int32), 1.0,
            8)[0].numpy()
    return got, want


@pytest.mark.parametrize("space", CLAHE_SPACES)
def test_image_clahe_and_colorspace_clahe_equal_jax(space):
    img = _rgb((48, 61), seed=11)
    got_l, want_l = _lightness_clahe(space, img)
    with jax.disable_jit():
        want = np.asarray(jclahe.image_clahe(jnp.asarray(img), 1.0, 8, space))
        want_c = np.asarray(jclahe.image_colorspace_clahe(
            jnp.asarray(img), 1.0, 8, space))
    x = torch.from_numpy(img)
    got = tclahe.image_clahe(x, 1.0, 8, space).numpy()
    got_c = tclahe.image_colorspace_clahe(x, 1.0, 8, space).numpy()
    _held(got_l, want_l, got, want)
    _held(got_l, want_l, got_c, want_c)
    np.testing.assert_array_equal(got_c[..., 0], got_l)
    # a batch of one through the same call (the device split's form)
    np.testing.assert_array_equal(
        tclahe.image_clahe(x[None], 1.0, 8, space)[0].numpy(), got)


@pytest.mark.parametrize("space", CLAHE_SPACES)
def test_image_clahe_masked_equals_jax(space):
    """A padded (64, 64) bucket holding a (45, 58) photo: the valid
    rectangle's CLAHE as the JAX masked chain computes it."""
    img = _rgb((64, 64), seed=12)
    hw = (45, 58)
    img[hw[0]:] = 0
    img[:, hw[1]:] = 0
    got_l, want_l = _lightness_clahe(space, img, hw)
    with jax.disable_jit():
        want = np.asarray(jclahe.image_clahe_masked(jnp.asarray(img), hw, 1.0,
                                                    8, space))
    got = tclahe.image_clahe_masked(
        torch.from_numpy(img)[None], torch.tensor([hw], dtype=torch.int32),
        1.0, 8, space)[0].numpy()
    v = (slice(0, hw[0]), slice(0, hw[1]))
    _held(got_l[v], want_l[v], got[v], want[v])


@pytest.mark.parametrize("space", CLAHE_SPACES)
def test_add_clahe_fromrgb_and_apply_clahe_transforms(space):
    img = _rgb((40, 44), seed=13)
    four = np.concatenate([img, img[..., :1]], -1)
    got_l, want_l = _lightness_clahe(space, img)
    with jax.disable_jit():
        want = jT.AddClaheFromRgb(1.0, 8, space)(four)[0]
        want_a = jT.ApplyClahe(1.0, 8, space)(img)[0]
    got = tT.AddClaheFromRgb(1.0, 8, space)(torch.from_numpy(four)).numpy()
    got_a = tT.ApplyClahe(1.0, 8, space)(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (40, 44, 5)
    np.testing.assert_array_equal(got[..., :4], four)
    _held(got[..., 4], want[..., 4], got, want)
    _held(got_l, want_l, got_a, want_a)


@pytest.mark.parametrize("space", CLAHE_SPACES)
def test_device_split_takes_the_space(space):
    """`pil2np | apply_clahe:1.0:8:<space> | totensor | normalize` splits
    into the device function, which gives the host chain's values, exact
    and masked: the same uint8 lightness, the rest within 1e-5 (torch's
    vectorized and scalar loops round a power differently by an ulp)."""
    imnet = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
    chain = "pil2np | apply_clahe:1.0:8:%s | totensor | normalize" % space
    host_fn, device_fn = tT.split_device_transform(chain, imnet)
    assert device_fn is not None
    u8 = (_rgb((33, 41), seed=14) * 255).astype(np.uint8)
    host = tT.initialize_transforms(chain, imnet)(u8).numpy()
    x = torch.from_numpy(host_fn(u8)).float() / 255.0
    np.testing.assert_allclose(device_fn(x[None])[0].numpy(), host,
                               atol=1e-5, rtol=0)
    padded = torch.zeros(1, 64, 64, 3)
    padded[0, :33, :41] = x
    mask = torch.zeros(1, 64, 64)
    mask[0, :33, :41] = 1
    masked = device_fn(padded, mask)[0, :33, :41].numpy()
    np.testing.assert_allclose(masked, host, atol=1e-5, rtol=0)
