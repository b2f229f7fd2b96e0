"""The port's transforms (gandtr_tpu_torch/data/transforms.py) against the
JAX package's, on the CPU: each of the 20 transforms this port adds to
the six it had, through both packages' `initialize_transforms`, on the
same numpy-seeded images and, after `seed_transforms`, the same draws.

- Crops, flips, noise and the channel transforms: bit-equal.
- `centerscalecrop`: its crop bit-equal; the resize within 2e-6 of cv2's
  (the port's cv2-order numpy resize, as tests/test_torch_gan_data.py
  holds `scalecrop`).
- The colorspace, CLAHE and histogram transforms: 1e-5 (CLAHE's uint8
  lightness may move one level on 0.1% of pixels, as
  tests/test_torch_colorspaces.py holds it).
- `Compose.draw`, the loader's plan ahead of decoding, gives the draws
  the JAX chain makes as it goes, through crops that change the shape
  and through `downscale` (PIL's thumbnail size, computed ahead).
"""
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu.data import transforms as jT
from gandtr_tpu_torch.data import transforms as tT

torch.set_num_threads(1)

MS3 = [[0.5, 0.4, 0.3], [0.2, 0.25, 0.3]]


def _photo(h, w, seed):
    rs = np.random.RandomState(seed)
    return Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8))


def _float(h, w, c, seed):
    return np.random.RandomState(seed).uniform(0, 1, (h, w, c)).astype(
        np.float32)


def _as_list(out):
    return [np.asarray(o) for o in (out if isinstance(out, (list, tuple))
                                    else [out])]


def _run(chain, pics, seed=3, ms=MS3):
    """Both packages' chain on `pics` after the same reseed."""
    jT.seed_transforms(seed)
    tT.seed_transforms(seed)
    with jax.disable_jit():
        want = _as_list(jT.initialize_transforms(chain, ms)(*pics))
    got = _as_list(tT.initialize_transforms(chain, ms)(*pics))
    assert [g.shape for g in got] == [w.shape for w in want]
    return got, want


def _equal(chain, pics, seed=3, ms=MS3):
    got, want = _run(chain, pics, seed, ms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


def _close(chain, pics, atol, seed=3, ms=MS3):
    got, want = _run(chain, pics, seed, ms)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
    return got


def test_registry_has_the_jax_keys():
    assert sorted(tT.TRANSFORMS) == sorted(jT.TRANSFORMS)
    with pytest.raises(KeyError):
        tT.initialize_transforms("pil2np | rotate:3", MS3)


@pytest.mark.parametrize("chain", [
    "pil2np | random_crop:24",
    "pil2np | random_crop:17_29 | totensor",
    "pil2np | mirror",
    "pil2np | mirror:0.9 | random_crop:20_12",
    "pil2np | gaussian_noise:0.05",
    "pil2np | random_crop:30 | gaussian_noise:0.1 | normalize",
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_transforms_bit_equal_on_the_same_draws(chain, seed):
    """Two images of different sizes: one window placed by the first, one
    flip for both, noise on the first only."""
    pics = [_photo(41, 37, seed), _photo(45, 52, seed + 10)]
    got = _equal(chain, pics, seed=seed)
    if "noise" in chain and "crop" not in chain:
        np.testing.assert_array_equal(
            got[1], np.asarray(pics[1], np.float32) / 255)


@pytest.mark.parametrize("chain", [
    "pil2np | center_crop:20",
    "pil2np | center_crop:21_16",
    "pil2np | center_crop:40_50",
    "pil2np | square_crop",
    "pil2np | stackbatch",
    "pil2np | nan_check | stackbatch | np_invert_chan:4",
    "pil2np | add_const:0.25 | np_chanselect:1",
    "pil2np | add_const:-1 | np_chanselect:1:3",
    "pil2np | np_chanselect:0:null",
    "pil2np | np_chanclone:1",
    "pil2np | np_chanclone:0:2",
    "pil2np | np_chanclone:1:null | np_invert_chan:0",
    "pil2np | add_const:0.5 | normalize:false",
])
def test_deterministic_transforms_bit_equal(chain):
    pics = [_photo(33, 28, 5), _photo(33, 28, 6)]
    ms = [[0.5, 0.4, 0.3, 0.2], [0.2, 0.25, 0.3, 0.35]] \
        if "normalize:false" in chain else MS3
    _equal(chain, pics, ms=ms)


def test_centerscalecrop_crop_and_resize():
    pics = [_photo(70, 90, 7), _photo(80, 75, 8)]
    got = _close("pil2np | centerscalecrop:32_24:0.6", pics, 2e-6)
    assert got[0].shape == (24, 32, 3)
    # at the target size already: passed through unchanged
    same = [_photo(24, 32, 9)]
    _equal("pil2np | centerscalecrop:32_24", same)


def test_nan_check_raises_in_both():
    bad = _float(6, 5, 3, 0)
    bad[2, 3, 1] = np.nan
    with pytest.raises(ValueError, match="Nan"):
        jT.initialize_transforms("nan_check", MS3)(bad)
    with pytest.raises(ValueError, match="Nan"):
        tT.initialize_transforms("nan_check", MS3)(bad)


@pytest.mark.parametrize("space", ["lab", "luv", "lsh", "hsv", "yxz", "gray",
                                   "bgr", "rgb", "sluv"])
def test_tospace_and_intensity(space):
    pics = [_photo(23, 31, 11)]
    _close("pil2np | tospace:%s" % space, pics, 1e-5)
    if space != "gray":
        _close("pil2np | add_intensity_fromrgb:%s" % space, pics, 1e-5)
    _close("pil2np | add_intensity_fromrgb", pics, 1e-5)


def _clahe_close(chain, pics):
    """1e-5 except where a uint8 lightness level moved (at most 0.1% of
    pixels, one level on the CLAHE'd channel)."""
    got, want = _run(chain, pics)
    for g, w in zip(got, want):
        moved = (np.abs(g - w) > 1e-5).any(-1)
        assert moved.mean() <= 1e-3, moved.mean()
    return got, want


@pytest.mark.parametrize("space", ["lab", "luv", "hsv"])
def test_clahe_transforms(space):
    pics = [_photo(40, 47, 12)]
    got, want = _clahe_close(
        "pil2np | apply_colorspaceclahe:1.0:8:%s" % space, pics)
    assert got[0].shape == (40, 47, 3)
    got, want = _clahe_close("pil2np | create_clahed:2.0:4:%s" % space, pics)
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("chain", [
    "pil2np | match_histogram:f3d_lab",
    "pil2np | match_histogram:b166b47:luv",
    "pil2np | match_histogram:eq",
    "pil2np | gamma_equalize:0.4",
    "pil2np | gamma_equalize:0.6:hsv",
])
def test_histogram_transforms(chain):
    _close(chain, [_photo(36, 30, 13), _photo(28, 26, 14)], 1e-5)


@pytest.mark.parametrize("created", ["append", "replace"])
def test_replace_histogram(created):
    a, b = _photo(30, 26, 15), _photo(30, 26, 16)
    # training form: two images, the first's last channel matched to the
    # second's, which loses it
    got = _close("pil2np | add_intensity_fromrgb | replace_histogram:"
                 "2cd274e:%s" % created, [a, b], 1e-5)
    assert got[0].shape[-1] == (4 if created == "replace" else 5)
    assert got[1].shape[-1] == 3
    # test form: one image, matched to a stored histogram or equalized
    for hist in ("2cd274e", "eq"):
        _close("pil2np | add_intensity_fromrgb | replace_histogram:%s:%s"
               % (hist, created), [a], 1e-5)


@pytest.mark.parametrize("chain", [
    "pil2np | random_crop:30 | mirror | gaussian_noise:0.02 | totensor | "
    "normalize",
    "pil2np | centerscalecrop:40_36:0.6 | random_crop:24_20 | mirror",
    "pil2np | scalecrop:32_32:0.5_0.9 | random_crop:16 | gaussian_noise:0.1",
    "pil2np | add_const:0.3 | random_crop:20 | gaussian_noise:0.1",
    "pil2np | stackbatch | gaussian_noise:0.1",
    "pil2np | create_clahed:2.0:4 | random_crop:21 | gaussian_noise:0.05",
])
def test_planned_draws_equal_the_jax_chain(chain):
    """The loader's form: `draw` from the images' (h, w) ahead of
    decoding, then the chain with those draws. Several items in a row, so
    the RNG stream stays aligned from item to item."""
    jT.seed_transforms(4)
    tT.seed_transforms(4)
    jc = jT.initialize_transforms(chain, MS3)
    tc = tT.initialize_transforms(chain, MS3)
    for item in range(3):
        pics = [_photo(64 + item, 71, item), _photo(66, 70 + item, item + 5)]
        if "stackbatch" in chain:
            pics[1] = _photo(64 + item, 71, item + 5)
        if "create_clahed" in chain:
            # one image of test_clahe_transforms' size (JAX's eager CLAHE
            # compiles its ops once for each shape)
            pics = [_photo(40, 47, item)]
        with jax.disable_jit():
            want = _as_list(jc(*pics))
        draws = tc.draw([(p.size[1], p.size[0]) for p in pics])
        got = _as_list(tc(*pics, draws=draws))
        assert len(got) == len(want)
        tol = 2e-6 if "scalecrop" in chain else 1e-5 if "clahe" in chain \
            else 0
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)


@pytest.mark.parametrize("chain", [
    "pil2np | downscale:40 | mirror | random_crop:24",
    "pil2np | downscale:33 | random_crop:20_17 | gaussian_noise:0.1",
])
def test_draw_through_downscale_equals_the_jax_chain(chain):
    """downscale's output size is planned from PIL's thumbnail arithmetic,
    so random transforms after it draw what the JAX chain draws as it
    goes, on portrait, landscape and square photos."""
    jT.seed_transforms(5)
    tT.seed_transforms(5)
    jc = jT.initialize_transforms(chain, MS3)
    tc = tT.initialize_transforms(chain, MS3)
    for item, (h, w) in enumerate([(64, 47), (45, 71), (50, 50), (61, 59)]):
        pics = [_photo(h, w, item)]
        with jax.disable_jit():
            want = _as_list(jc(*pics))
        got = _as_list(tc(*pics, draws=tc.draw([(h, w)])))
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0], want[0])


def test_downscale_plans_pils_thumbnail_size():
    side = 37
    down = tT.Downscale(side)
    for h in range(1, 120, 7):
        for w in range(1, 120, 5):
            im = Image.new("L", (w, h))
            im.thumbnail((side, side), Image.LANCZOS)
            assert down.out_shapes([(h, w, 3)], None) == \
                [(im.size[1], im.size[0], 3)], (h, w)
