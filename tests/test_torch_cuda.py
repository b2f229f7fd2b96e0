"""The port on the card: K1 to K4 against their plain versions (K2 and K3
also at shapes that are no multiple of their tiles, and with images smaller
than a tile), the served path and the fine-tune step on `cuda`. Marked `cuda`; each test skips where torch sees no GPU. Run on
a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets JAX up, and the port's GPU
machine needs no JAX.)"""
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,grid,clip", [
    ((2, 768, 1024), 8, 1.0), ((29, 35), 4, 4.0), ((3, 37, 53), 8, 1.0),
    # cv2's pad larger than the image; H divides the grid and W does not
    ((3, 5), 8, 1.0), ((2, 32, 37), 8, 4.0), ((2, 32, 36), 4, 1.0)])
def test_k1_bit_equal_to_plain(cuda, shape, grid, clip):
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.ops.clahe import clahe_u8_plain
    img = np.random.RandomState(0).randint(0, 256, shape, dtype=np.uint8)
    x = torch.from_numpy(img).to(cuda)
    before = kclahe.LAUNCHES
    got = kclahe.clahe_u8_cuda(x, clip, grid)
    torch.cuda.synchronize()
    assert kclahe.LAUNCHES == before + 1
    assert torch.equal(got, clahe_u8_plain(x, clip, grid))


def _block_case(shape, seed=0):
    """_random_case of tests/test_resblock_pallas.py at any shape."""
    N, H, W, C = shape
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, H, W, C) * 0.5).astype(np.float32)
    w1 = (rng.randn(3, 3, C, C) * 0.05).astype(np.float32)
    w2 = (rng.randn(3, 3, C, C) * 0.05).astype(np.float32)
    b1 = (rng.randn(C) * 0.1).astype(np.float32)
    b2 = (rng.randn(C) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("shape", [(2, 17, 23, 64), (2, 16, 24, 256),
                                   (1, 48, 64, 128), (2, 33, 18, 64),
                                   (1, 11, 45, 128), (2, 9, 33, 256),
                                   (1, 6, 7, 16), (1, 10, 9, 320)])
def test_k3_matches_plain(cuda, shape):
    """K3 against its plain version on the same bf16 inputs: they share every
    rounding point and differ in summation order only, so the bound is the
    JAX kernel test's (tests/test_resblock_pallas.py:47-49); two launches on
    the same input are bit-equal (fixed reduction order, no atomics)."""
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.kernels import resblock as kres
    from gandtr_tpu_torch.ops.resblock import (fused_resblock,
                                               fused_resblock_plain)
    set_float32_policy()
    x, w1, b1, w2, b2 = [torch.from_numpy(a).to(cuda).to(torch.bfloat16)
                         for a in _block_case(shape)]
    before = kres.LAUNCHES
    got = fused_resblock(x, w1, b1, w2, b2)
    again = fused_resblock(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert kres.LAUNCHES == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, again)
    d = (got.float() - fused_resblock_plain(x, w1, b1, w2, b2).float()).abs()
    assert float(d.max()) < 0.06 and float(d.mean()) < 0.01


def test_k3_refuses_what_it_does_not_take(cuda):
    from gandtr_tpu_torch.kernels.resblock import fused_resblock_cuda
    C = 24
    x = torch.zeros((1, 8, 8, C), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((9 * C, C), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros((C,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="C % 16"):
        fused_resblock_cuda(x, w, b, w, b)
    x = torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((9 * 32, 32), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros((32,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_resblock_cuda(x.permute(0, 2, 1, 3), w, b, w, b)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_resblock_cuda(x.float(), w, b, w, b)


def test_served_descriptor_matches_cpu(cuda):
    """TF32 off on the card: within 1e-4 of the port on the CPU."""
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.serving.export import Servable
    img = np.random.RandomState(1).randint(0, 256, (1, 96, 128, 3),
                                           dtype=np.uint8)
    on_card = Servable(hub.gem_vgg16_hedngan(), (96, 128))(img)
    on_cpu = Servable(hub.gem_vgg16_hedngan(device="cpu"), (96, 128))(img)
    np.testing.assert_allclose(on_card, on_cpu, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(2, 30, 26, 64), (2, 15, 13, 128),
                                   (1, 64, 48, 64), (2, 33, 70, 64),
                                   (1, 21, 45, 128), (3, 7, 5, 64),
                                   (4, 3, 9, 128), (2, 1, 1, 64)])
@pytest.mark.parametrize("out_dtype,tol", [(torch.float32, 2e-5),
                                           (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("relu", [False, True])
def test_k2_matches_plain(cuda, shape, out_dtype, tol, relu):
    """K2 against its plain version on the same bf16 inputs: the same exact
    products, summed in another order (tests/test_vggconv_pallas.py:38,
    :51); two launches bit-equal."""
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.ops.vggconv import conv3x3_same_plain
    set_float32_policy()
    C = shape[-1]
    rng = np.random.RandomState(C + shape[1])
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(3, 3, C, C) / (3 * np.sqrt(C)))
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(C).astype(np.float32)).to(cuda)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    before = kvgg.LAUNCHES
    got = kvgg.conv3x3_same_cuda(x, w.reshape(9 * C, C), b, relu, out_dtype)
    again = kvgg.conv3x3_same_cuda(x, w.reshape(9 * C, C), b, relu,
                                   out_dtype)
    torch.cuda.synchronize()
    assert kvgg.LAUNCHES == before + 2
    assert got.dtype == out_dtype and torch.equal(got, again)
    want = conv3x3_same_plain(x, w, b, relu, out_dtype).float()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_conv_kernels_bit_equal_on_repeat(cuda, kernel):
    """Three launches at a path shape (K2: the fine-tune's conv2_2, K3: a
    served block of 2 images) are bit-equal: no split K, no atomics."""
    from gandtr_tpu_torch.kernels import resblock as kres
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    g = torch.Generator(device=cuda).manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * scale).to(
            torch.bfloat16)

    if kernel == "K2":
        C = 128
        args = (randn(7, 182, 182, C), randn(9 * C, C, scale=0.03),
                torch.randn(C, generator=g, device=cuda))
        outs = [kvgg.conv3x3_same_cuda(*args, relu=True) for _ in range(3)]
    else:
        C = 256
        args = (randn(2, 192, 256, C, scale=0.5), randn(9 * C, C, scale=0.05),
                randn(C, scale=0.1), randn(9 * C, C, scale=0.05),
                randn(C, scale=0.1))
        outs = [kres.fused_resblock_cuda(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0].float()).all()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_k2_backward_under_the_kernels_mask(cuda):
    """Conv3x3Same's gradients (K2 forward) against autograd of the float32
    conv of the same bf16 values under the kernel's ReLU mask."""
    from gandtr_tpu_torch.ops.vggconv import Conv3x3Same
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 19, 23, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 64, 64) / 24).astype(np.float32))
    b = torch.from_numpy(rng.randn(64).astype(np.float32))
    co = torch.from_numpy(rng.randn(2, 19, 23, 64).astype(np.float32))
    x, w, b, co = (t.to(cuda) for t in (x, w, b, co))
    xb = x.to(torch.bfloat16).requires_grad_(True)
    wb = w.to(torch.bfloat16).requires_grad_(True)
    bf = b.clone().requires_grad_(True)
    y = Conv3x3Same.apply(xb, wb, bf, True, torch.bfloat16)
    (y.float() * co).sum().backward()
    xr = xb.detach().float().requires_grad_(True)
    wr = wb.detach().float().requires_grad_(True)
    br = b.clone().requires_grad_(True)
    yr = torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2),
                                    wr.permute(3, 2, 0, 1), br, padding=1)
    (torch.where(y.detach() > 0, yr.permute(0, 2, 3, 1), 0.0)
     * co).sum().backward()
    for got, want in ((xb.grad, xr.grad), (wb.grad, wr.grad),
                      (bf.grad, br.grad)):
        d = float((got.float() - want).abs().max())
        assert d <= 0.01 * float(want.abs().max()) + 1e-6, d


@pytest.mark.parametrize("bucket,rects", [
    (64, [(41, 57), (64, 64), (29, 35)]),
    (364, [(362, 241), (272, 362), (362, 362), (41, 57)]),
    # the pad larger than the rectangle; h divides the grid and w does not
    (61, [(3, 5), (32, 37), (40, 56), (61, 61), (1, 1)]),
    # the eval's geometry (shape_bucket 64): photos of longest side 1024
    # and one kept at 800x600, and a query's bbx crop, each in its bucket
    ((768, 1024), [(768, 1024)]), ((1024, 704), [(1024, 683)]),
    ((640, 832), [(600, 800)]), ((768, 576), [(768, 547)])])
@pytest.mark.parametrize("clip,grid", [(1.0, 8), (4.0, 4)])
def test_k4_bit_equal_to_plain(cuda, bucket, rects, clip, grid):
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.clahe import clahe_u8_masked_plain
    Hb, Wb = bucket if isinstance(bucket, tuple) else (bucket, bucket)
    rng = np.random.RandomState(Hb)
    img = np.zeros((len(rects), Hb, Wb), np.uint8)
    for i, (h, w) in enumerate(rects):
        img[i, :h, :w] = rng.randint(0, 256, (h, w))
    x = torch.from_numpy(img).to(cuda)
    hw = torch.tensor(rects, dtype=torch.int32, device=cuda)
    before = kmasked.LAUNCHES
    got = kmasked.clahe_u8_masked_cuda(x, hw, clip, grid)
    torch.cuda.synchronize()
    assert kmasked.LAUNCHES == before + 1
    assert torch.equal(got, clahe_u8_masked_plain(x, hw, clip, grid))


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_clahe_one_kernel_a_call(cuda, kernel):
    """K1 and K4 are one launch of one kernel (csrc/clahe.cu) a call, with
    no LUT tensor between two kernels."""
    import chip_smoke
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    if kernel == "K1":
        x = torch.randint(0, 256, (8, 768, 1024), dtype=torch.uint8,
                          device=cuda)
        assert chip_smoke._stream_launches(
            lambda: kclahe.clahe_u8_cuda(x, 1.0, 8)) == 1
    else:
        img, hw = chip_smoke.k4_batch(cuda)
        assert chip_smoke._stream_launches(
            lambda: kmasked.clahe_u8_masked_cuda(img, hw, 1.0, 8)) == 1


def test_finetune_step_launches_k2_and_k4(cuda):
    """One bf16 fine-tune step through its entry point at a small size (the
    generator cut to ngf 4 and one block, a 32 bucket): a finite loss, K2
    twice and K4 once per tuple."""
    import chip_smoke
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    cfg = chip_smoke.finetune_config()
    cfg["network"]["augment"]["model"].update(ngf=4, n_blocks=1)
    exp = build_finetune_experiment(cfg)
    rng = np.random.RandomState(0)
    T, S = 2, 7
    imgs = torch.from_numpy(rng.randint(0, 256, (T, S, 32, 32, 3),
                                        dtype=np.uint8)).to(cuda)
    hws = torch.tensor([[(30, 26), (26, 30)] * 3 + [(32, 32)]] * T,
                       dtype=torch.int32, device=cuda)
    labels = torch.tensor([[-1, 1, 0, 0, 0, 0, 0]] * T, dtype=torch.float32,
                          device=cuda)
    pmask = torch.zeros((T, S), dtype=torch.bool, device=cuda)
    pmask[0, 0] = True
    k2, k4 = kvgg.LAUNCHES, kmasked.LAUNCHES
    _, m = exp["step"](exp["state"], imgs, hws, labels, pmask)
    assert np.isfinite(float(m["total"]))
    assert (kvgg.LAUNCHES - k2, kmasked.LAUNCHES - k4) == (2 * T, T)


def test_bucketed_extractor_matches_exact(cuda, tmp_path):
    """The eval's extractor (eval.yml's network and data sections, seeded
    weights and Lw) with shape_bucket 64 against exact shapes, on two
    photos: within 1e-4."""
    import pickle
    import chip_smoke
    from gandtr_tpu_torch.scenarios.validate_stage import build_eval
    lw = tmp_path / "lw.pkl"
    with open(lw, "wb") as f:
        pickle.dump(chip_smoke.seeded_lw(), f)
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((683, 1024), (1024, 768))]
    out = {}
    for bucket in (64, None):
        params = chip_smoke.eval_params(str(tmp_path), str(lw), bucket)
        ex = build_eval(params, cuda)["extractor"]
        out[bucket] = torch.stack([ex(im) for im in imgs]).cpu()
    assert out[64].shape == (2, 512)
    assert float((out[64] - out[None]).abs().max()) <= 1e-4


def test_finetune_loop_launches_k2_and_k4(cuda, tmp_path):
    """One epoch of the loop on the micro set of
    tests/test_torch_finetune_loop.py (16 seeded 48x40 JPEGs in 8 clusters,
    image_size 32, a generator of ngf 4 and one block, the embed in bf16)
    through the entry point on cuda: every mining extraction batch launches
    K4 once and K2 twice, each step K4 once and K2 twice a tuple; the loss
    is finite and the epoch's checkpoint loads."""
    import chip_smoke
    from PIL import Image
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.learning.wrappers import cir_hash_passthrough
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    rng = np.random.RandomState(0)
    images = []
    for i in range(16):
        path = str(tmp_path / ("im%02d.jpg" % i))
        Image.fromarray((rng.rand(48, 40, 3) * 255).astype(np.uint8)
                        ).save(path)
        images.append(path)
    db = {"cids": ["im%02d" % i for i in range(16)],
          "cluster": [i // 2 for i in range(16)],
          "qidxs": [0, 2, 4, 6], "pidxs": [1, 3, 5, 7]}
    cfg = chip_smoke.finetune_config()
    cfg["network"]["augment"]["model"].update(ngf=4, n_blocks=1)
    cfg["learning"]["training"]["epochs"] = 1
    cfg["data"] = {"train": {
        "dataset": {"image_size": 32, "neg_num": 2, "pool_size": 12,
                    "query_size": 3, "qpool_size": 4, "similar_exclude": 0.2,
                    "similar_include": 0.8},
        "loader": {"batch_size": 3, "num_workers": 1}}}
    exp = build_finetune_experiment(cfg, directory=str(tmp_path / "exp"),
                                    db=db, images=images)
    k2, k4 = kvgg.LAUNCHES, kmasked.LAUNCHES
    exp["training"].run(exp["state"])
    gated = sum(cir_hash_passthrough("im%02d" % q, 0.25) for q in db["qidxs"])
    batches = int(gated > 0) + int(gated < 4) + 1   # anchors, then the pool
    steps_t = 3                                       # one step of 3 tuples
    assert (kvgg.LAUNCHES - k2, kmasked.LAUNCHES - k4) == (
        2 * (batches + steps_t), batches + steps_t)
    assert np.isfinite(
        exp["events"].history[0]["metrics"]["train/learning/total"])
    best = exp["checkpoints"].load_net("embed", "_best")
    exp["models"]["embed"].module.load_state_dict(best["model_state"])


def test_r101_path_launches_k4_and_k1(cuda, tmp_path):
    """The finetune_r101 chain at full depth on the loop's micro set (16
    seeded 48x40 JPEGs, image_size 32): step 1 launches K4 once for each
    mining extraction batch and each tuple and never K2 (ResNet-101 takes
    no VGG conv); step 2 from its embed_best.ckpt launches K4 once a batch,
    and K4 at those inputs equals its plain version; step 4, exact, launches
    K1 once a photo, with 2048-d descriptors."""
    import pickle
    import chip_smoke
    from PIL import Image
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.learning.wrappers import cir_hash_passthrough
    from gandtr_tpu_torch.ops.clahe import clahe_u8_masked_plain
    from gandtr_tpu_torch.scenarios import validate_stage
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    from gandtr_tpu_torch.scenarios.multistep_stage import \
        infer_and_learn_whitening
    rng = np.random.RandomState(0)
    images = []
    for i in range(16):
        path = str(tmp_path / ("im%02d.jpg" % i))
        Image.fromarray((rng.rand(48, 40, 3) * 255).astype(np.uint8)
                        ).save(path)
        images.append(path)
    db = {"cids": ["im%02d" % i for i in range(16)],
          "cluster": [i // 2 for i in range(16)],
          "qidxs": [0, 2, 4, 6], "pidxs": [1, 3, 5, 7]}
    cfg = chip_smoke.finetune_r101_config("unused.pkl", "unused")
    cfg["network"]["augment"]["model"].update(ngf=4, n_blocks=1)
    cfg["learning"]["training"]["epochs"] = 1
    cfg["data"] = {"train": {
        "dataset": {"image_size": 32, "neg_num": 2, "pool_size": 12,
                    "query_size": 3, "qpool_size": 4, "similar_exclude": 0.2,
                    "similar_include": 0.8},
        "loader": {"batch_size": 3, "num_workers": 1}}}
    directory = str(tmp_path / "exp")
    exp = build_finetune_experiment(cfg, directory=directory, db=db,
                                    images=images)
    k2, k4 = kvgg.LAUNCHES, kmasked.LAUNCHES
    exp["training"].run(exp["state"])
    gated = sum(cir_hash_passthrough("im%02d" % q, 0.25) for q in db["qidxs"])
    batches = int(gated > 0) + int(gated < 4) + 1   # anchors, then the pool
    assert (kvgg.LAUNCHES - k2, kmasked.LAUNCHES - k4) == (0, batches + 3)

    ckpt = str(tmp_path / "exp" / "epochs" / "embed_best.ckpt")
    wpkl = chip_smoke.make_whiten_set(str(tmp_path / "whiten"), images, db)
    calls = []
    restore = chip_smoke._recording_calls(kmasked, "clahe_u8_masked_cuda",
                                          calls)
    try:
        k1, k4 = kclahe.LAUNCHES, kmasked.LAUNCHES
        (meta,) = infer_and_learn_whitening(chip_smoke.r101_whitening_params(
            ckpt, wpkl, str(tmp_path / "whiten" / "ims"), directory), None)
    finally:
        restore()
    assert kclahe.LAUNCHES == k1 and kmasked.LAUNCHES - k4 == len(calls) > 0
    for args, kwargs in calls:
        assert torch.equal(kmasked.clahe_u8_masked_cuda(*args, **kwargs),
                           clahe_u8_masked_plain(*args, **kwargs))
    with open(meta["whitening_path"], "rb") as f:
        assert pickle.load(f)["P"].shape == (2048, 2048)

    root = str(tmp_path / "eval")
    chip_smoke.make_eval_set(root)
    k1 = kclahe.LAUNCHES
    _, rec = chip_smoke._recorded(validate_stage, lambda: validate_stage
                                  .validate(chip_smoke.r101_eval_params(
                                      root, ckpt, meta["whitening_path"],
                                      None), None))
    assert kclahe.LAUNCHES - k1 == chip_smoke.EVAL_DB + chip_smoke.EVAL_Q
    assert rec[0][2].shape == (2048, chip_smoke.EVAL_DB)


def _gan_micro(root, batch=2, size=4):
    """chip_smoke's train_hedngan.yml at micro widths (ngf 8 with 2 blocks,
    ndf 8, HED at width 0.25) on its seeded domain set, 64x64 crops."""
    import chip_smoke
    cfg = chip_smoke.gan_train_config(root, chip_smoke.make_domain_set(root))
    net = cfg["network"]
    net["generator_X"]["model"].update(ngf=8, n_blocks=2)
    net["discriminator_Y"]["model"].update(ndf=8)
    for k in ("detector", "detector_frozen"):
        net[k]["model"]["width_mult"] = 0.25
    cfg["data"]["train"]["transforms"] = \
        "pil2np | scalecrop:64_64:0.8_1 | totensor | normalize"
    cfg["data"]["train"]["loader"] = {"batch_size": batch}
    cfg["data"]["train"]["dataset"]["size"] = size
    return cfg


def test_gan_step_on_card_matches_cpu(cuda, tmp_path):
    """The HED^N-GAN step on the card against the port on the CPU from the
    same seeded weights: the step-1 tie exact on both (E_real 0), the
    losses within 1e-4 relative, fake_Y within 1e-5, BN statistics within
    1e-5; D's and the student's gradients in the step, and the generator's
    two G-step terms on the starting weights, each no further from a
    float64 CPU reference than twice the CPU float32's distance or 1e-5 of
    its norm (float32 rounding's level: at these widths either device
    lands 1e-7 to 3e-6 away, and which is nearer is chance); no kernel of
    the port launched. As a sanity check only, every updated parameter
    within 2 lr (Adam's first step is lr times g/(|g| + eps), below lr for
    any g)."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    import chip_smoke
    cfg = _gan_micro(str(tmp_path))
    rs = np.random.RandomState(0)
    X, Y = (rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(2))

    def grads(dev, dtype):
        exp = build_gan_experiment(cfg, device=dev)
        if dtype == torch.float64:
            for net in exp["models"].values():
                net.module.double()
        x = torch.from_numpy(X).to(dev, dtype)
        y = torch.from_numpy(Y).to(dev, dtype)
        terms = chip_smoke._g_grad_terms(exp, x)
        got = chip_smoke._grab_grads(exp, chip_smoke.GAN_OPTIMIZED)
        _, m, dbg = exp["step"](exp["state"], x, y)
        flat = {"G_adv": terms[0].double(), "G_edge": terms[1].double(),
                "D": chip_smoke._flat(got["discriminator_Y"]).double(),
                "E": chip_smoke._flat(got["detector"]).double()}
        return exp, m, dbg, flat

    _, _, _, ref = grads("cpu", torch.float64)
    out, vs64 = {}, {}
    chip_smoke.reset_launches()
    for dev in ("cpu", cuda):
        exp, m, dbg, flat = grads(dev, torch.float32)
        vs64[str(dev)] = {k: chip_smoke._rel(v, ref[k])
                          for k, v in flat.items()}
        out[str(dev)] = ({k: float(v) for k, v in m.items()},
                         dbg["fake_Y"].cpu(),
                         {name: {k: v.detach().cpu() for k, v in
                                 net.module.state_dict().items()}
                          for name, net in exp["models"].items()})
    assert chip_smoke.launches() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    for k, v in vs64[str(cuda)].items():
        assert v <= max(2 * vs64["cpu"][k], 1e-5), (k, vs64)
    (cm, cf, cs), (gm, gf, gs) = out["cpu"], out[str(cuda)]
    assert cm["E_real"] == gm["E_real"] == 0.0
    for k, v in cm.items():
        assert abs(gm[k] - v) <= 1e-4 * max(abs(v), 1e-6), k
    assert float((gf - cf).abs().max()) <= 1e-5
    lrs = {name: c["lr"] for name, c in
           cfg["learning"]["training"]["optimizer"].items()}
    for name in cs:
        for k, v in cs[name].items():
            d = float((gs[name][k].double() - v.double()).abs().max())
            if k.endswith(("running_mean", "running_var")):
                assert d <= 1e-5, (name, k, d)
            elif name in lrs and not k.endswith("num_batches_tracked"):
                # HED's groups scale its lr by up to 200
                mult = 200 if name == "detector" else 1
                assert d <= 2 * lrs[name] * mult * (1 + 1e-6), (name, k, d)
            else:
                assert d == 0, (name, k, d)


def test_gan_loop_resume_on_card(cuda, tmp_path):
    """Two epochs of two steps through the loop on the card, then a copy
    of the directory as it was after epoch 1 resumed: epoch 2 ends bit for
    bit equal (the fixed-order reflect pad and resize backward, cuDNN's
    deterministic algorithms, the loader's saved shuffle)."""
    import shutil
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    cfg = _gan_micro(str(tmp_path))
    root = str(tmp_path / "exp")
    exp = build_gan_experiment(cfg, directory=root)

    def hook(state, epoch):
        if epoch == 1:
            shutil.copytree(root, root + "_1", symlinks=True)
    exp["training"].state_hook = hook
    state = exp["training"].run(exp["state"])
    rexp = build_gan_experiment(cfg, directory=root + "_1")
    rstate, start = rexp["training"].resume_or_start(rexp["state"])
    assert start == 2
    rstate = rexp["training"].run(rstate, start_epoch=start)
    for name, net in state.models.items():
        got = rstate.models[name].module.state_dict()
        for k, v in net.module.state_dict().items():
            assert torch.equal(v, got[k]), (name, k)
    for name, opt in state.optimizers.items():
        got = rstate.optimizers[name].state_dict()["state"]
        for i, s in opt.state_dict()["state"].items():
            for k, v in s.items():
                assert torch.equal(v, got[i][k]), (name, i, k)


def test_teacher_cache_bit_equal_on_card(cuda, tmp_path):
    """The build's teacher cache on the card: two epochs over the same
    two batches hit twice, miss twice, and end bit for bit where the plain
    step ends from the same weights."""
    import copy
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    cfg = _gan_micro(str(tmp_path))
    cfg.pop("data")
    ccfg = copy.deepcopy(cfg)
    ccfg["learning"]["training"]["epoch_iteration"][
        "cache_teacher_targets"] = {"max_items": 4}
    plain = build_gan_experiment(cfg, device=cuda)
    cached = build_gan_experiment(ccfg, device=cuda)
    rs = np.random.RandomState(1)
    batches = [tuple(rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
                     for _ in range(2)) for _ in range(2)]
    ps, cs = plain["state"], cached["state"]
    for _ in range(2):
        for X, Y in batches:
            ps, _, _ = plain["step"](ps, torch.from_numpy(X).to(cuda),
                                     torch.from_numpy(Y).to(cuda))
            cs, _, _ = cached["step"](cs,
                                      *cached["step"].batch_to_args((X, Y)))
    assert (cached["step"].hits, cached["step"].misses) == (2, 2)
    for name, net in plain["models"].items():
        got = cached["models"][name].module.state_dict()
        for k, v in net.module.state_dict().items():
            assert torch.equal(got[k], v), (name, k)


def test_device_resize_matches_host_chain_on_card(cuda):
    """The device scalecrop's resize on the card against the host chain's
    cv2-form resize of the same crops: within 1e-6."""
    from gandtr_tpu_torch.data.transforms import resize_linear
    from gandtr_tpu_torch.ops.resize import dynamic_bilinear_resize_u8
    rs = np.random.RandomState(2)
    pad, bufs, hws, crops = 320, [], [], []
    for _ in range(10):
        h, w = int(rs.randint(256, pad + 1)), int(rs.randint(256, pad + 1))
        crop = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
        buf = np.zeros((pad, pad, 3), np.uint8)
        buf[:h, :w] = crop
        bufs.append(buf)
        hws.append((h, w))
        crops.append(crop)
    got = dynamic_bilinear_resize_u8(
        torch.from_numpy(np.stack(bufs)).to(cuda),
        torch.tensor(hws).to(cuda), 256, 256).cpu().numpy()
    for g, crop in zip(got, crops):
        want = resize_linear(crop.astype(np.float32) / 255.0, 256, 256)
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("no_sigmoid", [False, True])
def test_rcf_on_card_matches_cpu(cuda, no_sigmoid):
    """RCF (seeded, full width) at 37x45 on the card within 1e-4 of the
    CPU; its parameter gradients on the card bit-equal on repeat."""
    from gandtr_tpu_torch.hub import _init_random
    from gandtr_tpu_torch.models import initialize_model
    net = _init_random(initialize_model({"architecture": "rcf"}), 3)
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 37, 45, 3)).astype(np.float32))
    with torch.no_grad():
        want = net(x, no_sigmoid=no_sigmoid)
    net.to(cuda)
    got = net(x.to(cuda), no_sigmoid=no_sigmoid)
    assert float((got.detach().cpu() - want).abs().max()) <= 1e-4
    grads = []
    for _ in range(2):
        net.zero_grad(set_to_none=True)
        net(x.to(cuda), no_sigmoid=no_sigmoid).abs().mean().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _family_micro(root, family):
    """chip_smoke's family `train` section at micro widths (ngf 8 with 2
    blocks, ndf 8; RCF at full width) on its seeded domain set, 64x64
    crops, 2 epochs of 2 steps, seeded detector files."""
    import chip_smoke
    from gandtr_tpu_torch.scenarios.engine import load_yaml_scenario
    pth = chip_smoke.seeded_detectors(root)
    cfg = load_yaml_scenario([chip_smoke.FAMILY_YML[family]]
                             + chip_smoke.family_overrides(family, pth))
    cfg = cfg["train"]["1_train_augment"]
    lists = chip_smoke.make_domain_set(root)
    net = cfg["network"]
    net["generator_X"]["model"].update(ngf=8, n_blocks=2)
    net["discriminator_Y"]["model"].update(ndf=8)
    data = cfg["data"]["train"]
    data["dataset"].update(dataset_X=lists[0], dataset_Y=lists[1],
                           image_dir=os.path.join(root, "ims") + "/*",
                           size=4 if family != "cut" else 2)
    data["transforms"] = "pil2np | scalecrop:64_64:0.8_1 | " \
        "totensor | normalize"
    if family != "cut":
        data["loader"] = {"batch_size": 2}
    cfg["learning"]["training"]["epochs"] = 2
    cfg["learning"]["validation"]["visual"]["criterion"]["data"][
        "dataset"]["image_dir"] = os.path.join(root, "val")
    return cfg


@pytest.mark.parametrize("family", ["rcfngan", "cut"])
def test_family_resume_on_card(cuda, tmp_path, family):
    """RCF^N-GAN and CUT (drawn patch positions): two epochs of two steps
    on the card, then a copy of the directory after epoch 1 resumed:
    epoch 2 ends bit for bit equal, networks, moments and the patch
    generator; no kernel launched."""
    import shutil
    import chip_smoke
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    cfg = _family_micro(str(tmp_path), family)
    root = str(tmp_path / "exp")
    exp = build_gan_experiment(cfg, directory=root)

    def hook(state, epoch):
        if epoch == 1:
            shutil.copytree(root, root + "_1", symlinks=True)
    exp["training"].state_hook = hook
    chip_smoke.reset_launches()
    state = exp["training"].run(exp["state"])
    assert chip_smoke.launches() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    rexp = build_gan_experiment(cfg, directory=root + "_1")
    rstate, start = rexp["training"].resume_or_start(rexp["state"])
    assert start == 2
    rstate = rexp["training"].run(rstate, start_epoch=start)
    for name, net in state.models.items():
        got = rstate.models[name].module.state_dict()
        for k, v in net.module.state_dict().items():
            assert torch.equal(v, got[k]), (name, k)
    a, b = state.state_dict(), rstate.state_dict()
    chip_smoke._same_tree(a, b, (family,))


def test_patch_positions_same_on_card_and_cpu(cuda):
    """PatchSampleF draws its positions on the CPU: the same generator
    seed gives the same positions for maps on the card and on the CPU."""
    from gandtr_tpu_torch.models.patchsample import PatchSampleF
    pf = PatchSampleF(nc=8).create_mlp([4])
    feats = [torch.randn(1, 16, 16, 4)]
    _, a = pf(feats, 64, generator=torch.Generator().manual_seed(5))
    pf.to(cuda)
    _, b = pf([feats[0].to(cuda)], 64,
              generator=torch.Generator().manual_seed(5))
    assert b[0].device.type == "cuda" and torch.equal(a[0], b[0].cpu())


def test_k1_and_k3_from_a_loaded_artifact(cuda, tmp_path):
    """The descriptor and bf16 generator artifacts exported on the card:
    the loaded programs launch K1 once and K3 once a block a batch (the
    wrappers' counts), and give the direct op call's values bit for bit."""
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import resblock as kres
    from gandtr_tpu_torch.serving.export import (Servable, export_hub_model,
                                                 load_artifact)
    hw = (96, 128)
    img = np.random.RandomState(8).randint(0, 256, (2,) + hw + (3,),
                                           dtype=np.uint8)
    emb = hub.gem_vgg16_hedngan(pretrained=False)
    export_hub_model(emb, str(tmp_path / "emb"), hw, batch_buckets=(2,))
    gen = hub.cyclegan(pretrained=False)
    gen.net.compute_dtype = torch.bfloat16
    export_hub_model(gen, str(tmp_path / "gen"), hw, batch_buckets=(2,))
    for name, model, mod, per_batch in (("emb", emb, kclahe, 1),
                                        ("gen", gen, kres, 9)):
        art = load_artifact(str(tmp_path / name))
        before = mod.LAUNCHES
        got = art(img)
        torch.cuda.synchronize()
        assert mod.LAUNCHES == before + per_batch, name
        want = Servable(model, hw, batch_buckets=(2,))(img)
        np.testing.assert_array_equal(got, want)


def test_exact_topk_ties_on_card(cuda):
    """Duplicated database rows on the card: the exact index returns them
    lower index first, as on the CPU and as lax.top_k."""
    from gandtr_tpu_torch.serving.index import RetrievalIndex, exact_topk
    rng = np.random.RandomState(9)
    base = rng.randn(300, 32).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    X = np.tile(base, (70, 1))                       # 21,000 rows
    q = base[[3, 17, 250]]
    s = torch.from_numpy(q @ X.T)
    v_cpu, i_cpu = exact_topk(s, 20)
    v_gpu, i_gpu = exact_topk(s.to(cuda), 20)
    assert torch.equal(i_gpu.cpu(), i_cpu) and torch.equal(v_gpu.cpu(), v_cpu)
    index = RetrievalIndex(32, devices=[cuda, cuda])
    index.add([str(i) for i in range(len(X))], X)
    for qi, row in zip(q, (3, 17, 250)):
        names = [int(n) for n, _ in index.query(qi, k=70)[0]]
        assert names == [row + 300 * r for r in range(70)]


@pytest.mark.parametrize("kind", ["down", "up"])
def test_blur_backward_is_deterministic(cuda, kind):
    """The blur-pool layers' backward (a depthwise conv and a depthwise
    transposed conv on the edge-slice pads) gives the same input gradient
    bit for bit on repeat, and the CPU's within 1e-5: a blur-pool GAN
    resumes bit for bit."""
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.models.layers import BlurDownsample, BlurUpsample
    set_float32_policy()
    C = 64
    m = (BlurDownsample(C) if kind == "down" else BlurUpsample(C))
    x = torch.from_numpy(np.random.RandomState(0).randn(
        4, 64, 48, C).astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(1).randn(
        *m(x).shape).astype(np.float32))
    grads = []
    for dev in (cuda, cuda, torch.device("cpu")):
        xx = x.to(dev).requires_grad_(True)
        m.to(dev)(xx).backward(g.to(dev))
        grads.append(xx.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    assert float((grads[0] - grads[2]).abs().max()) <= 1e-5


@pytest.mark.parametrize("cfg", [
    {"architecture": "official_resnet_generator", "ngf": 16, "n_blocks": 2,
     "no_antialias": False, "no_antialias_up": False,
     "norm_layer": "instance"},
    {"architecture": "official_unet_generator", "ngf": 8, "num_downs": 6,
     "norm_layer": "batch"}], ids=["blur_resnet", "unet"])
def test_generator_training_backward_is_deterministic(cuda, cfg):
    """The blur-pool generator and the U-Net in training mode: forward and
    every parameter gradient bit for bit on repeat on the card, the
    forward within 1e-4 of the CPU's."""
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.models import initialize_model
    from gandtr_tpu_torch.models.init import initialize_weights
    set_float32_policy()
    net = initialize_weights(initialize_model(dict(cfg)), "kaiming_p2p", 0)
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    runs = []
    for dev in (cuda, cuda, torch.device("cpu")):
        net.to(dev).train().zero_grad(set_to_none=True)
        y = net(x.to(dev))
        y.square().mean().backward()
        runs.append((y.detach().cpu(),
                     [p.grad.cpu() for p in net.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert float((runs[0][0] - runs[2][0]).abs().max()) <= 1e-4


@pytest.mark.parametrize("model", [
    {"architecture": "cirnet", "cir_architecture": "vgg16",
     "pooling": "gem", "regional": True},
    {"architecture": "cirnet", "cir_architecture": "vgg16",
     "pooling": {"type": "GeometricMedianWeiszfeld", "iterations": 3}},
    {"architecture": "cirnet_attention", "cir_architecture": "vgg16"},
    {"architecture": "cirnet_inchan", "cir_architecture": "vgg16",
     "inputs": {"preprocessing": {"type": "edgefilter"}}}],
    ids=["regional", "geometric_median", "attention", "edge_filter"])
def test_descriptor_nets_on_the_card(cuda, model):
    """The regional, geometric-median, attention and edge-filter nets
    (seeded VGG16) on the card within 1e-5 of the CPU at 224x160."""
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.hub import _init_random
    from gandtr_tpu_torch.models import initialize_model
    set_float32_policy()
    net = _init_random(initialize_model(dict(model)), 3).eval()
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 224, 160, 3).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("n,K,D,k", [(3000, 2000, 512, 1), (500, 700, 64, 3),
                                     (41, 4096, 512, 1)])
def test_grouping_chunked_nearest_bit_equal_on_card(cuda, n, K, D, k):
    """The chunked nearest-centroid search (models/grouping.py::nearest) on
    the card: every chunk width gives the unchunked result bit for bit,
    ties to the lower index."""
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.models.grouping import GEMM_ROWS, nearest
    set_float32_policy()
    rs = np.random.RandomState(12)
    a = torch.from_numpy(rs.randn(n, D).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rs.randn(K, D).astype(np.float32)).to(cuda)
    b[7] = b[3]
    want = nearest(a, b, k, chunk=K)
    for chunk in (GEMM_ROWS, 3 * GEMM_ROWS, 1000):
        got = nearest(a, b, k, chunk=chunk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool((want[1] == 7).any())


@pytest.mark.parametrize("top", [None, 24])
def test_grouping_hard_path_bit_equal_twice_on_card(cuda, top):
    """The hard path (res, top-1, uniform, l2norm, maxass), with and
    without top-centroid reduction, twice on the card: descriptors,
    weights and the gradients into the features and the codebook bit for
    bit (its sums per centroid add with no atomics); within 1e-5 of the
    CPU port."""
    from gandtr_tpu_torch.models.grouping import Codebook
    rs = np.random.RandomState(13)
    book = rs.randn(96, 32).astype(np.float32)
    feats = [book[rs.randint(96, size=n)] + 0.3 * rs.randn(n, 32)
             for n in (700, 650, 500)]
    runs = []
    for dev in (cuda, cuda, torch.device("cpu")):
        cb = Codebook(book, "res", "top", "uniform", "l2norm", "maxass",
                      top_centroids=top).to(dev)
        ims = [(torch.tensor(f, dtype=torch.float32, device=dev,
                             requires_grad=True),
                torch.ones(f.shape[0], 1, device=dev)) for f in feats]
        d, w = cb(ims)
        R = torch.from_numpy(rs.__class__(14).randn(*d.shape).astype(
            np.float32)).to(dev)
        (d * R).sum().backward()
        runs.append([t.detach().cpu() for t in
                     [d, w, cb.codebook.grad] + [f.grad for f, _ in ims]])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for a, b in zip(runs[0], runs[2]):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


def test_parallel_nccl_world_one_bit_equal(cuda):
    """One rank over NCCL: finetune.yml's bf16 step (chip_smoke's phase
    19 (b), T=4) bit-equal to the run without a process group, K2 and K4
    launched."""
    import chip_smoke as c
    one = c._par_finetune(cuda, {"devices": 2})
    counts = c._par_nccl(cuda, one)
    assert counts["K2"] == 2 * c.PAR_T and counts["K4"] == c.PAR_T


def test_parallel_two_ranks_gan_step_on_card(cuda):
    """Two gloo ranks sharing the card (tests/torch_dp_workers.py) run
    train_hedngan.yml's step at full width on a global batch of 4 at 64²,
    BatchNorm over the global batch: the metrics equal on both ranks and
    within 1e-3 relative of one process's step."""
    import chip_smoke as c
    from torch_dp_workers import gan_steps, spawn
    X, Y = c._seeded_gan_batches(1, 4, 64, 7)[0]
    r0, r1 = spawn("gan_steps", cfg=c._par_gan_cfg({"devices": 2}),
                   batches=[(X, Y)], device="cuda")
    one = gan_steps(c._par_gan_cfg(False), [(X, Y)], device="cuda")
    assert r0["data_parallel"] and not one["data_parallel"]
    assert r0["metrics"] == r1["metrics"]
    for k, v in one["metrics"][0].items():
        assert abs(r0["metrics"][0][k] - v) <= 1e-3 * max(abs(v), 1e-6), k


def _two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    return torch.cuda.device_count()


def test_round_robin_extraction_over_distinct_cards(cuda, tmp_path):
    """eval.yml's extractor in one process over every card (the default
    `parallel_extract`): successive photos go to each card in turn, and
    the descriptors, moved to the first card, equal one card's bit for
    bit, exact and bucketed."""
    import pickle
    import chip_smoke
    from PIL import Image
    from gandtr_tpu_torch.eval.retrieval import extract_vectors
    from gandtr_tpu_torch.scenarios.validate_stage import build_eval
    n_cards = _two_cards(cuda)
    lw = tmp_path / "lw.pkl"
    with open(lw, "wb") as f:
        pickle.dump(chip_smoke.seeded_lw(), f)
    rng = np.random.RandomState(4)
    paths = []
    for i, (h, w) in enumerate([(300, 400), (400, 300), (320, 320),
                                (240, 360), (360, 240)]):
        paths.append(str(tmp_path / ("p%d.jpg" % i)))
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(paths[-1], quality=90)
    for bucket in (None, 64):
        params = chip_smoke.eval_params(str(tmp_path), str(lw), bucket)
        size = params["data"]["image_size"]
        setup = build_eval(params, cuda)
        many, tf = setup["extractor"], setup["transform"]
        assert len(many.devices) == n_cards
        params["data"]["parallel_extract"] = False
        one = build_eval(params, cuda)["extractor"]
        assert one.devices is None
        got = extract_vectors(many, paths, size, tf)
        assert many._rr == len(paths)
        np.testing.assert_array_equal(
            got, extract_vectors(one, paths, size, tf))


def test_nccl_gathers_across_cards(cuda):
    """parallel/mesh.py's NCCL all-gather with a rank on each card (up
    to 4): the equal split's rows and the strided split's (unequal
    counts) come back whole and in input order on every rank."""
    from torch_dp_workers import spawn
    world = min(_two_cards(cuda), 4)
    n_items = 4 * world + 1
    want = torch.arange(n_items, dtype=torch.float32)[:, None] \
        * torch.tensor([1.0, 2.0, 3.0])
    for r, out in enumerate(spawn("gather", world=world, backend="nccl",
                                  n_items=n_items)):
        assert out["device"] == "cuda:%d" % r
        assert torch.equal(out["equal"], want[:4 * world])
        assert torch.equal(out["strided"], want)


def test_sharded_generator_artifact_on_card(cuda, tmp_path):
    """The bf16 generator sharded 2 ways on [cuda, cuda] (a stream a
    share) against its unsharded artifact at 64x96: within one uint8
    level; K3 9 launches a share."""
    import chip_smoke as c
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.serving.export import (export_hub_model,
                                                 export_sharded_model,
                                                 load_artifact)
    gen = hub.cyclegan(pretrained=False)
    gen.net.compute_dtype = torch.bfloat16
    hw = (64, 96)
    export_sharded_model(gen, str(tmp_path / "s"), hw, 2,
                         batch_per_device=2)
    export_hub_model(gen, str(tmp_path / "u"), hw, batch_buckets=(4,))
    x = np.random.RandomState(3).randint(0, 256, (4,) + hw + (3,),
                                         dtype=np.uint8)
    sharded = load_artifact(str(tmp_path / "s"), devices=[cuda, cuda])
    c.reset_launches()
    got = sharded(x)
    assert c.launches()["K3"] == 18
    want = load_artifact(str(tmp_path / "u"), device=cuda)(x)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
