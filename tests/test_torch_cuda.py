"""The port on the card: K1 to K4 against their plain versions (K2 and K3
also at shapes that are no multiple of their tiles, and with images smaller
than a tile), the served path and the fine-tune step on `cuda`. Marked `cuda`; each test skips where torch sees no GPU. Run on
a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets JAX up, and the port's GPU
machine needs no JAX.)"""
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
