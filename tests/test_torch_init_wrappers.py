"""The port's weight-init schemes (gandtr_tpu_torch/models/init.py) and
its last three wrappers (learning/wrappers.py) against the JAX package,
on the CPU, in the style of tests/test_init_differential.py: the random
draws come from other generators, so they are held by their statistics
on large tensors; what is deterministic is held exactly.

- Each scheme: the drawn std (and mean) of conv, transposed-conv and
  linear weights, biases and BatchNorm scales against the scheme's law and
  against the JAX package's draws on the same shapes; the exact parts
  (p2p biases 0, BatchNorm bias 0, he_normal bias 0.01, norm layers left
  alone by the simple schemes); the TypeError of a simple scheme given
  parameters; the gain of `init_gain` / `gain`.
- The GAN build hands a member's whole `initialize:` dict to the scheme:
  `{weights: normal_p2p, init_gain: 0.02}` draws at 0.02, as the JAX
  build does (it dropped the gain before and drew at 0.2).
- `reflectpad_divisible`, `random_pass_through` (a given mask; the rate
  of the drawn one) and `fakebatch` around a small net: 1e-5 of JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from gandtr_tpu.learning import wrappers as jW
from gandtr_tpu.models.init import initialize_weights as j_init
from gandtr_tpu_torch.learning import wrappers as tW
from gandtr_tpu_torch.models.init import initialize_weights as t_init

torch.set_num_threads(1)


def _module():
    torch.manual_seed(0)
    m = nn.Sequential(nn.Conv2d(32, 64, 3, padding=1), nn.BatchNorm2d(64),
                      nn.Linear(64, 128),
                      nn.ConvTranspose2d(64, 16, 4, stride=2))
    with torch.no_grad():
        m[1].weight.fill_(7.0)
        m[1].bias.fill_(7.0)
    return m


def _jax_params():
    """The JAX layout of the same layers: HWIO kernels, (in, out) dense,
    a transposed conv's (kh, kw, in, out)."""
    z = np.zeros
    return {"conv": {"kernel": z((3, 3, 32, 64), np.float32),
                     "bias": z((64,), np.float32)},
            "bn": {"scale": np.full((64,), 7.0, np.float32),
                   "bias": np.full((64,), 7.0, np.float32)},
            "dense": {"kernel": z((64, 128), np.float32),
                      "bias": z((128,), np.float32)},
            "convT": {"kernel": z((4, 4, 64, 16), np.float32),
                      "bias": z((16,), np.float32)}}


def _draws(weights, **kw):
    m = t_init(_module(), weights, seed=3, **kw)
    got = {"conv": (m[0].weight, m[0].bias), "bn": (m[1].weight, m[1].bias),
           "dense": (m[2].weight, m[2].bias),
           "convT": (m[3].weight, m[3].bias)}
    got = {k: tuple(v.detach().numpy() for v in vs) for k, vs in got.items()}
    params = j_init(_jax_params(), jax.random.PRNGKey(3), weights=weights,
                    **kw)
    want = {k: (np.asarray(v.get("kernel", v.get("scale"))),
                np.asarray(v["bias"])) for k, v in params.items()}
    return got, want


FANS = {"conv": (288, 576), "dense": (64, 128), "convT": (1024, 256)}


def _std_law(weights, name, gain):
    fan_in, fan_out = FANS[name]
    return {"normal_p2p": gain, "kaiming_p2p": np.sqrt(2.0 / fan_in),
            "xavier_p2p": gain * np.sqrt(2.0 / (fan_in + fan_out)),
            "normal": 1.0, "he_normal": np.sqrt(2.0 / fan_in),
            "uniform": np.sqrt(1 / 12.0)}[weights]


@pytest.mark.parametrize("weights,kw", [
    ("normal_p2p", {}), ("normal_p2p", {"init_gain": 0.02}),
    ("kaiming_p2p", {"gain": 0.05}), ("xavier_p2p", {}),
    ("xavier_p2p", {"init_gain": 0.02}),
    ("normal", {}), ("uniform", {}), ("he_normal", {}),
])
def test_scheme_statistics_and_exact_parts_against_jax(weights, kw):
    got, want = _draws(weights, **kw)
    gain = kw.get("init_gain", kw.get("gain", 0.2))
    for name in ("conv", "dense", "convT"):
        (gw, gb), (ww, wb) = got[name], want[name]
        assert gw.size == ww.size
        law = _std_law(weights, name, gain)
        for w in (gw, ww):
            assert abs(w.std() / law - 1) < 0.08, (name, w.std(), law)
        if weights == "uniform":
            assert 0 <= gw.min() and gw.max() < 1
            assert abs(gw.mean() - 0.5) < 0.02
        if weights.endswith("_p2p"):
            assert not gb.any() and not wb.any()
        elif weights == "he_normal":
            np.testing.assert_array_equal(gb, np.full_like(gb, 0.01))
            np.testing.assert_array_equal(wb, np.full_like(wb, 0.01))
        elif name != "convT":
            # normal / uniform draw the biases too (and so does JAX)
            assert gb.std() > 0.1 and wb.std() > 0.1
    (gs, gbb), (ws, wbb) = got["bn"], want["bn"]
    if weights.endswith("_p2p"):
        for s in (gs, ws):
            assert abs(s.mean() - 1) < 4 * gain / 8 and \
                abs(s.std() / gain - 1) < 0.3
        assert not gbb.any() and not wbb.any()
    else:   # the simple schemes leave norm layers alone
        np.testing.assert_array_equal(gs, np.full(64, 7.0, np.float32))
        np.testing.assert_array_equal(gbb, np.full(64, 7.0, np.float32))
        np.testing.assert_array_equal(ws, gs)


def test_draws_are_seeded_and_in_module_order():
    a = t_init(_module(), "normal_p2p", seed=4, init_gain=0.02)
    b = t_init(_module(), "normal_p2p", seed=4, init_gain=0.02)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    g = torch.Generator().manual_seed(4)
    first = torch.randn(a[0].weight.shape, generator=g) * 0.02
    assert torch.equal(a[0].weight, first)


@pytest.mark.parametrize("weights", ["normal", "uniform", "he_normal"])
def test_simple_scheme_with_parameters_raises_in_both(weights):
    with pytest.raises(TypeError, match="takes no parameters"):
        j_init(_jax_params(), jax.random.PRNGKey(0), weights=weights,
               init_gain=0.02)
    with pytest.raises(TypeError, match="takes no parameters"):
        t_init(_module(), weights, seed=0, init_gain=0.02)
    with pytest.raises(NotImplementedError):
        t_init(_module(), "orthogonal", seed=0)


@pytest.mark.parametrize("spec,gain", [
    ({"weights": "normal_p2p", "init_gain": 0.02, "seed": 1}, 0.02),
    ({"weights": "normal_p2p", "seed": 1}, 0.2),
])
def test_gan_member_draws_at_its_init_gain(tmp_path, spec, gain):
    """ROADMAP C.1, repaired: the build passes `init_gain` through. The
    generator's conv weights draw at the gain and its BatchNorm scales
    about 1 with that std, as the JAX scheme draws on the same shapes."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    from torch_gan_common import micro_config
    cfg = micro_config(str(tmp_path))
    cfg["network"]["generator_X"]["initialize"] = dict(spec)
    gen = build_gan_experiment(cfg, device="cpu")["models"][
        "generator_X"].module
    convs = np.concatenate([m.weight.detach().numpy().ravel()
                            for m in gen.modules()
                            if isinstance(m, (nn.Conv2d,
                                              nn.ConvTranspose2d))])
    scales = np.concatenate([m.weight.detach().numpy().ravel()
                             for m in gen.modules()
                             if isinstance(m, nn.BatchNorm2d)])
    assert convs.size > 2000 and scales.size >= 64
    params = {"c": {"kernel": np.zeros((convs.size, 1), np.float32)},
              "b": {"scale": np.zeros(scales.size, np.float32)}}
    jspec = {k: v for k, v in spec.items() if k != "seed"}
    jax_draw = j_init(params, jax.random.PRNGKey(1), **jspec)
    for c in (convs, np.asarray(jax_draw["c"]["kernel"])):
        assert abs(c.std() / gain - 1) < 0.1
    for s in (scales, np.asarray(jax_draw["b"]["scale"])):
        assert abs(s.mean() - 1) < gain / 2 and abs(s.std() / gain - 1) < 0.3


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

W = np.random.RandomState(0).uniform(-1, 1, (3, 3)).astype(np.float32)


def _net_jax(x):
    """A small net that mixes channels and rows (so a pad shows)."""
    return jnp.tanh(x @ W) + 0.5 * jnp.roll(x, 1, axis=-3)


def _net_torch(x):
    return torch.tanh(x @ torch.from_numpy(W)) + 0.5 * torch.roll(
        x, 1, dims=-3)


def _both(spec, x, ctx_j=None, ctx_t=None):
    with jax.disable_jit():
        want = np.asarray(jW.apply_wrapped(jW.initialize_wrappers(spec),
                                           _net_jax, jnp.asarray(x),
                                           ctx_j or {}))
    got = tW.apply_wrapped(tW.initialize_wrappers(spec), _net_torch,
                           torch.from_numpy(x), ctx_t or {}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    return got


def test_registry_has_the_jax_keys():
    assert sorted(tW.WRAPPERS_LABELS) == sorted(jW.WRAPPERS_LABELS)


@pytest.mark.parametrize("shape,d", [((2, 13, 18, 3), 4), ((1, 16, 7, 3), 8),
                                     ((3, 8, 8, 3), 4)])
def test_reflectpad_divisible_against_jax(shape, d):
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    got = _both("reflectpad_divisible:%d" % d, x)
    assert got.shape[1:3] == shape[1:3]
    _both({"0_reflectpad_divisible": {"divisible_by": d}}, x)


def test_random_pass_through_against_jax():
    """With a given mask: the net's output on its rows, the input on the
    others."""
    x = np.random.RandomState(2).uniform(-1, 1, (6, 5, 4, 3)).astype(
        np.float32)
    mask = np.array([True, False, False, True, True, False])
    got = _both("random_pass_through:0.5", x, {"pass_mask": mask},
                {"pass_mask": torch.from_numpy(mask)})
    np.testing.assert_array_equal(got[~mask], x[~mask])
    np.testing.assert_array_equal(
        got[mask], _net_torch(torch.from_numpy(x[mask])).numpy())


def test_random_pass_through_rate_and_selection():
    """Without a mask each image passes the net with the probability: the
    drawn rate within 4 sigma of 0.3 over 20,000 images, as JAX's
    bernoulli; a row either equals the net's output or the input."""
    n, p = 20000, 0.3
    x = torch.full((n, 1, 1, 4), -2.0)
    w = tW.RandomPassThrough(p)
    gen = torch.Generator().manual_seed(0)
    y = tW.apply_wrapped([w], lambda t: t + 1.0, x, {"generator": gen})
    took = (y == -1.0).all(-1).flatten()
    assert ((y == -1.0) | (y == -2.0)).all()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(took.float().mean().item() - p) < 4 * sigma
    with jax.disable_jit():
        yj = jW.apply_wrapped([jW.RandomPassThrough(p)], lambda t: t + 1.0,
                              jnp.full((n, 1, 1, 4), -2.0),
                              {"rng": jax.random.PRNGKey(0)})
    assert abs(float((np.asarray(yj)[:, 0, 0, 0] == -1.0).mean()) - p) \
        < 4 * sigma
    # the same generator state draws the same mask
    y2 = tW.apply_wrapped([w], lambda t: t + 1.0, x,
                          {"generator": torch.Generator().manual_seed(0)})
    assert torch.equal(y, y2)


def test_fakebatch_against_jax():
    rs = np.random.RandomState(3)
    x5 = rs.uniform(-1, 1, (2, 3, 5, 6, 3)).astype(np.float32)
    got = _both("fakebatch", x5)
    assert got.shape == (2, 3, 5, 6, 3)
    x4 = rs.uniform(-1, 1, (4, 5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _both("fakebatch", x4), _net_torch(torch.from_numpy(x4)).numpy())
