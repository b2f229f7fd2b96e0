"""The port's GeM VGG16 net and its ops against the JAX package, on the CPU,
on the same weights (carried across with utils/weights.from_jax_variables)
and the same seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.ops import norm as jnorm
from gandtr_tpu.ops import pooling as jpool
from gandtr_tpu.ops import resize as jresize
from gandtr_tpu.ops import whiten as jwhiten
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.ops import norm as tnorm
from gandtr_tpu_torch.ops import pooling as tpool
from gandtr_tpu_torch.ops import resize as tresize
from gandtr_tpu_torch.ops import whiten as twhiten
from gandtr_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

CFG = {"architecture": "cirnet", "cir_architecture": "vgg16",
       "pooling": "gem", "local_whitening": False, "whitening": False}


def _pair(cfg=CFG, shape=(48, 64)):
    jnet = j_initialize_model(cfg)
    variables = jnet.init(jax.random.PRNGKey(0),
                          jnp.zeros((1,) + shape + (3,), jnp.float32))
    tnet = initialize_model(cfg)
    tnet.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return jnet, variables, tnet.eval()


def _x(shape, n=2, seed=0):
    return np.random.RandomState(seed).randn(n, *shape, 3).astype(np.float32)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53), (64, 80)])
def test_descriptors_match_jax(shape):
    """Full-width VGG16 + GeM + L2N. Tolerance 1e-5 on unit-norm (N, 512)
    descriptors: both run float32 on the CPU, and differ only in the
    convolutions' summation order."""
    jnet, variables, tnet = _pair(shape=shape)
    x = _x(shape)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_weights_roundtrip_through_jax_importer():
    """port state_dict -> the JAX importer (convert_torch_state with the
    retrieval key map) -> from_jax_variables gives identical arrays, with
    both whitening heads, so every layout rule is exercised."""
    cfg = dict(CFG, local_whitening=True, whitening=True)
    jnet = j_initialize_model(cfg)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    tnet = initialize_model(cfg)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tnet.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    state = {k: v.numpy() for k, v in tnet.state_dict().items()}
    variables = ti.convert_torch_state(template, state,
                                       key_map=ti.retrieval_key_map)
    back = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k].numpy(), state[k])
    initialize_model(cfg).load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", ["gem", "mac", "spoc"])
def test_pooling_matches_jax(name):
    x = np.abs(_x((5, 7), n=3, seed=1)) * 2
    want = np.asarray(getattr(jpool, name)(jnp.asarray(x)))
    got = getattr(tpool, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_gem_learnable_p_matches_jax():
    x = np.abs(_x((5, 7), n=3, seed=2))
    want = np.asarray(jpool.gem(jnp.asarray(x), p=jnp.float32(2.5)))
    got = tpool.gem(torch.from_numpy(x), p=torch.tensor([2.5])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_l2n_matches_jax():
    x = _x((1, 1), n=4, seed=3).reshape(4, 3)
    np.testing.assert_allclose(tnorm.l2n(torch.from_numpy(x)).numpy(),
                               np.asarray(jnorm.l2n(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale", [1 / np.sqrt(2), 0.5])
@pytest.mark.parametrize("shape", [(37, 53), (64, 80)])
def test_scale_resize_matches_jax(scale, shape):
    """torch's own bilinear F.interpolate is what the JAX code imitates:
    the same output size int(H * s). Values agree to 1e-5 on inputs of
    order 1: the two combine the four taps in another order (the JAX code
    rows first, then columns), so they differ by float32 rounding."""
    x = _x(shape, seed=4)
    want = np.asarray(jresize.scale_resize(jnp.asarray(x), scale))
    got = tresize.scale_resize(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape == (2, int(shape[0] * scale),
                                       int(shape[1] * scale), 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_whitenapply_matches_jax():
    rng = np.random.RandomState(5)
    X = rng.randn(16, 6).astype(np.float32)
    m = rng.randn(16, 1).astype(np.float32)
    P = rng.randn(16, 16).astype(np.float32)
    for dims in (None, 8):
        want = np.asarray(jwhiten.whitenapply(jnp.asarray(X), jnp.asarray(m),
                                              jnp.asarray(P), dims))
        got = twhiten.whitenapply(torch.from_numpy(X), torch.from_numpy(m),
                                  torch.from_numpy(P), dims).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
