"""The port on the card: K1 against its plain version and the served path
on `cuda`. Marked `cuda`; each test skips where torch sees no GPU. Run on
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
    ((2, 768, 1024), 8, 1.0), ((29, 35), 4, 4.0), ((3, 37, 53), 8, 1.0)])
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
                                   (1, 48, 64, 128)])
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
