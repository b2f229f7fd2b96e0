"""The port's GAN training data against the JAX package's, on the CPU: the
`scalecrop` and `downscale` transforms (the same random draws and crops,
the pixels within float rounding of cv2's resize), the RandomDomainsPair
dataset over epochs, a thread-pool loader giving the sequential loop's
batches, and InferImageList."""
import copy

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu.data import datasets as jds
from gandtr_tpu.data import transforms as JT
from gandtr_tpu_torch.data import datasets as pds
from gandtr_tpu_torch.data import transforms as PT
from torch_gan_common import micro_config

torch.set_num_threads(1)

# cv2's vector code fuses multiply-adds that the numpy replica rounds
# apart: 2 ulp of a value in [0, 1], twice that after (x - 0.5) / 0.5
RESIZE_TOL = 2.4e-7


def _pics(shapes, seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(h, w, 3).astype(np.float32) for h, w in shapes]


@pytest.mark.parametrize("seed,shapes", [
    (0, [(48, 64), (40, 50)]), (1, [(36, 36), (36, 36)]),
    (2, [(300, 400), (362, 241)]), (3, [(33, 90)])])
def test_scalecrop_against_jax(seed, shapes):
    """The same scale and offset drawn from the reseeded RNG, so the same
    crop of every image (JAX's `crop_only` replays the draws), and the
    resized pixels within RESIZE_TOL of JAX's cv2 resize."""
    pics = _pics(shapes, seed)
    JT.seed_transforms(seed)
    jcrops, _ = JT.RandomScaleCrop("32_32", "0.8_1").crop_only(*pics)
    JT.seed_transforms(seed)
    jout = JT.RandomScaleCrop("32_32", "0.8_1")(*pics)
    PT.seed_transforms(seed)
    (y, x), (ch, cw) = PT.RandomScaleCrop("32_32", "0.8_1").draw(
        [p.shape[:2] for p in pics])
    for p, jc in zip(pics, jcrops):
        assert np.array_equal(p[y:y + ch, x:x + cw], jc)
    PT.seed_transforms(seed)
    out = PT.RandomScaleCrop("32_32", "0.8_1").joint(
        [torch.from_numpy(p) for p in pics])
    for a, b in zip(out, jout):
        assert a.shape == (32, 32, 3)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=RESIZE_TOL)


def test_scalecrop_passes_images_at_its_size():
    pics = _pics([(32, 32), (32, 32)], 4)
    PT.seed_transforms(0)
    out = PT.RandomScaleCrop("32_32", "0.8_1").joint(pics)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(out, pics))
    assert PT._RNG.get_state()[2] == np.random.RandomState(0).get_state()[2]
    with pytest.raises(ValueError, match="does not fit"):
        PT.RandomScaleCrop("64_64", "0.8_1").draw([(40, 80)])


@pytest.mark.parametrize("channels", [(), (1,), (3,)])
def test_resize_linear_against_cv2(channels):
    """cv2.resize INTER_LINEAR's float path, up and down, over 200 random
    sizes: within RESIZE_TOL."""
    rs = np.random.RandomState(len(channels))
    for _ in range(200):
        h, w = rs.randint(2, 100, 2)
        oh, ow = rs.randint(1, 100, 2)
        x = rs.rand(h, w, *channels).astype(np.float32)
        want = cv2.resize(x, (int(ow), int(oh)))
        got = PT.resize_linear(x, int(ow), int(oh)).reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("as_pil", [False, True])
def test_downscale_against_jax(as_pil):
    """The LANCZOS thumbnail of the longest side, from a PIL image or from
    pil2np's float array (through uint8 by truncation): equal to JAX's."""
    rs = np.random.RandomState(5)
    u8 = rs.randint(0, 256, (90, 120, 3), dtype=np.uint8)
    if as_pil:
        want = JT.Downscale(40)(Image.fromarray(u8))[0]
        got = PT.Downscale(40)(Image.fromarray(u8))
        assert got.size == want.size == (40, 30)
        assert np.array_equal(np.asarray(got), np.asarray(want))
    else:
        f = JT.Pil2Numpy()(Image.fromarray(u8))[0]
        want = JT.Downscale(40)(f)[0]
        got = PT.Downscale(40)(PT.Pil2Numpy()(Image.fromarray(u8)))
        assert np.array_equal(got.numpy(), want)
        small = PT.Pil2Numpy()(Image.fromarray(u8[:20, :30]))
        assert PT.Downscale(40)(small) is small


def test_compose_takes_one_image_or_several():
    tf = PT.initialize_transforms(
        "pil2np | scalecrop:16_16:0.8_1 | totensor | normalize",
        [[0.5] * 3, [0.5] * 3])
    a, b = (Image.fromarray(np.full((20, 24, 3), v, np.uint8))
            for v in (0, 255))
    PT.seed_transforms(0)
    one = tf(a)
    assert isinstance(one, torch.Tensor) and one.shape == (16, 16, 3)
    PT.seed_transforms(0)
    two = tf(a, b)
    assert isinstance(two, list) and torch.equal(two[0], one)
    assert float(two[1].min()) == 1.0 and float(one.max()) == -1.0


def _loaders(root, workers=0):
    dp = micro_config(str(root), n=6, size=8)["data"]["train"]
    jl = jds.initialize_dataset_loader([], "train", copy.deepcopy(dp),
                                       {"shuffle": True})
    dp["loader"]["num_workers"] = workers
    pl = pds.initialize_dataset_loader([], copy.deepcopy(dp),
                                       {"shuffle": True})
    return jl, pl


def _epoch(loader, T, epoch):
    T.seed_transforms(epoch - 1)
    np.random.seed(epoch - 1)
    loader.dataset.prepare_epoch()
    return list(loader)


def test_random_domains_pair_against_jax(tmp_path):
    """Two epochs as the training loop draws them (numpy and the transform
    RNG reseeded with the zero-based epoch, the loader's own shuffle): the
    same pairs, and batches of pixels within 2 RESIZE_TOL."""
    jl, pl = _loaders(tmp_path)
    assert len(pl) == len(jl) == 4
    for epoch in (1, 2):
        jb, pb = _epoch(jl, JT, epoch), _epoch(pl, PT, epoch)
        assert pl.dataset.idxs_X == jl.dataset.idxs_X
        assert pl.dataset.idxs_Y == jl.dataset.idxs_Y
        for a, b in zip(jb, pb):
            for x, y in zip(a, b):
                assert y.shape == (2, 32, 32, 3) and y.dtype == np.float32
                np.testing.assert_allclose(y, x, rtol=0,
                                           atol=2 * RESIZE_TOL)


@pytest.mark.parametrize("workers", [2, 4])
def test_threaded_loader_gives_the_sequential_batches(tmp_path, workers):
    """With a thread pool the loader plans each item's draws in order
    first: the batches equal the single-threaded loop's bit for bit."""
    _, seq = _loaders(tmp_path, workers=0)
    _, par = _loaders(tmp_path, workers=workers)
    for epoch in (1, 2):
        a, b = _epoch(seq, PT, epoch), _epoch(par, PT, epoch)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
    assert not par.dataset._draws


def test_infer_image_list_against_jax(tmp_path):
    """Names and transformed images of the visual validation's dataset."""
    micro_config(str(tmp_path))
    names = ["v%d.jpg" % i for i in range(4)]
    tstr = "pil2np | downscale:40 | totensor | normalize"
    ms = [[0.5] * 3, [0.5] * 3]
    jd = jds.InferImageListDataset(
        [names], JT.initialize_transforms(tstr, ms), str(tmp_path / "val"))
    pd = pds.InferImageListDataset(
        [names], PT.initialize_transforms(tstr, ms), str(tmp_path / "val"))
    assert len(pd) == len(jd) == 4
    batches = list(pds.Loader(pd, batch_size=1, num_workers=2))
    for i in range(4):
        (jn, jimgs), (pn, pimgs) = jd[i], pd[i]
        assert pn == jn == (names[i],)
        assert pimgs.shape == (30, 40, 3)
        assert np.array_equal(pimgs.numpy(), jimgs)
        assert batches[i][0] == [pn]
        assert torch.equal(batches[i][1][0], pimgs)
