"""The port's VGG 3x3 conv (gandtr_tpu_torch/ops/vggconv.py: the plain
version of K2 and the Conv3x3Same backward) against the JAX package's
Pallas kernel in interpret mode and its custom VJP, on the CPU, at the
shapes and bounds of tests/test_vggconv_pallas.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.ops import vggconv_pallas
from gandtr_tpu_torch.kernels import vggconv as kvgg
from gandtr_tpu_torch.ops import vggconv

torch.set_num_threads(1)


def _case(C, H, W, seed, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, C) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("C,H,W", [(64, 16, 20), (64, 12, 14), (128, 16, 10),
                                   (128, 12, 9), (64, 10, 8)])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_jax_kernel(C, H, W, relu):
    """float32 out: both take bf16 operands and sum exact products in
    float32, so they differ in summation order only (2e-5, the JAX test's
    bound)."""
    x, w, b = _case(C, H, W, C + H + W + relu)
    want = np.asarray(vggconv_pallas.conv3x3_same(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu,
        interpret=True))
    got = vggconv.conv3x3_same(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), relu=relu).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_no_bias_bf16_out_matches_jax_kernel():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 12, 64).astype(np.float32)
    w = (rng.randn(3, 3, 64, 64) / 24.0).astype(np.float32)
    want = np.asarray(vggconv_pallas.conv3x3_same(
        jnp.asarray(x), jnp.asarray(w), None, out_dtype=jnp.bfloat16,
        interpret=True), np.float32)
    got = vggconv.conv3x3_same(torch.from_numpy(x), torch.from_numpy(w), None,
                               out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("relu,bias", [(True, True), (False, False)])
def test_backward_matches_jax_vjp(relu, bias):
    """Conv3x3Same's gradients against the JAX kernel's custom VJP
    (conv3x3_same_ad with the Pallas forward interpreted), to that test's
    bounds (tests/test_vggconv_pallas.py:91-93)."""
    rng = np.random.RandomState(7 + relu)
    x = rng.randn(2, 8, 10, 64).astype(np.float32)
    w = (rng.randn(3, 3, 64, 64) / 24.0).astype(np.float32)
    b = rng.randn(64).astype(np.float32) if bias else None
    co = rng.randn(2, 8, 10, 64).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, w, b) if a is not None]

    vggconv_pallas.set_force_interpret(True)
    try:
        def f(*a):
            return jnp.vdot(vggconv_pallas.conv3x3_same_ad(
                a[0], a[1], a[2] if bias else None, relu=relu),
                jnp.asarray(co))
        want = jax.grad(f, argnums=tuple(range(len(args))))(*args)
    finally:
        vggconv_pallas.set_force_interpret(False)

    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (x, w, b) if a is not None]
    y = vggconv.Conv3x3Same.apply(ts[0], ts[1], ts[2] if bias else None,
                                  relu, torch.float32)
    (y * torch.from_numpy(co)).sum().backward()
    for t, e in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(e), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_backward_equals_autograd_of_plain_under_the_kernels_mask(out_dtype):
    """The backward is autograd of the plain conv (float32 on the bf16
    values) with the forward's own ReLU mask imposed: the check
    chip_smoke.py makes of the kernel on the card."""
    x, w, b = _case(64, 9, 11, 3)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wb = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    bf = torch.from_numpy(b).requires_grad_(True)
    co = torch.from_numpy(np.random.RandomState(4).randn(*x.shape)
                          .astype(np.float32))
    y = vggconv.Conv3x3Same.apply(xb, wb, bf, True, out_dtype)
    (y.float() * co).sum().backward()
    mask = (y > 0).detach()
    xr = xb.detach().float().requires_grad_(True)
    wr = wb.detach().float().requires_grad_(True)
    br = bf.detach().clone().requires_grad_(True)
    yr = torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2),
                                    wr.permute(3, 2, 0, 1), br, padding=1)
    (torch.where(mask, yr.permute(0, 2, 3, 1), 0.0) * co).sum().backward()
    assert xb.grad.dtype == wb.grad.dtype == torch.bfloat16
    for got, want in ((xb.grad, xr.grad), (wb.grad, wr.grad),
                      (bf.grad, br.grad)):
        d = (got.float() - want).abs().max()
        assert float(d) <= 0.01 * float(want.abs().max()) + 1e-6, float(d)


def test_eligibility():
    el, bf = vggconv.eligible, torch.bfloat16
    assert el((7, 364, 364, 64), bf, 64, 64, 3, 1, 1, 1)
    assert el((7, 182, 182, 128), bf, 128, 128, 3, 1, 1, 1)
    assert not el((7, 364, 364, 64), torch.float32, 64, 64, 3, 1, 1, 1)
    assert not el((7, 364, 364, 3), bf, 3, 64, 3, 1, 1, 1)      # cin != cout
    assert not el((7, 46, 46, 256), bf, 256, 256, 3, 1, 1, 1)
    assert not el((7, 364, 364, 64), bf, 64, 64, 3, 2, 1, 1)    # stride
    assert not el((7, 364, 364, 64), bf, 64, 64, 5, 1, 1, 2)    # kernel
    assert not el((7, 364, 364, 64), bf, 64, 64, 3, 1, 2, 2)    # dilation


def test_wrapper_takes_cuda_tensors_only():
    before = kvgg.LAUNCHES
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    w = torch.zeros((576, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kvgg.conv3x3_same_cuda(x, w, torch.zeros(64), True)
    assert vggconv.conv3x3_same(x, w.view(3, 3, 64, 64)).shape == x.shape
    assert kvgg.LAUNCHES == before
