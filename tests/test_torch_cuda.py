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


def test_served_descriptor_matches_cpu(cuda):
    """TF32 off on the card: within 1e-4 of the port on the CPU."""
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.serving.export import Servable
    img = np.random.RandomState(1).randint(0, 256, (1, 96, 128, 3),
                                           dtype=np.uint8)
    on_card = Servable(hub.gem_vgg16_hedngan(), (96, 128))(img)
    on_cpu = Servable(hub.gem_vgg16_hedngan(device="cpu"), (96, 128))(img)
    np.testing.assert_allclose(on_card, on_cpu, atol=1e-4, rtol=0)
