"""The port's ResNet generator against the JAX package's, on the CPU, on the
same weights (carried across with utils/weights.from_jax_variables) and the
same seeded inputs, at a small size: 2 blocks, ngf 32 (blocks of C = 128)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.learning.network import WrappedNet as JWrappedNet
from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.models.init import initialize_weights as j_initialize_weights
from gandtr_tpu.ops import resblock_pallas as rp
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch import hub as thub
from gandtr_tpu_torch.learning.network import WrappedNet
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.init import initialize_weights
from gandtr_tpu_torch.ops import resblock
from gandtr_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

SHAPES = [(64, 64), (64, 96)]


def _cfg(norm):
    return {"architecture": "official_resnet_generator",
            "no_antialias": True, "no_antialias_up": True, "input_nc": 3,
            "output_nc": 3, "n_blocks": 2, "ngf": 32, "norm_layer": norm}


def _jax_variables(norm, seed=0):
    """JAX init, then kaiming_p2p (activations of unit scale, an unsaturated
    tanh) and, for batch norm, non-trivial running statistics."""
    jgen = j_initialize_model(_cfg(norm))
    v = dict(jgen.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))
    v["params"] = j_initialize_weights(v["params"], jax.random.PRNGKey(seed),
                                       weights="kaiming_p2p")
    if norm == "batch":
        rng = np.random.RandomState(seed + 3)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(
                rng.randn(*a.shape) * 0.1 if p[-1].key == "mean"
                else rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            v["batch_stats"])
    return jgen, v


def _pair(norm):
    jgen, v = _jax_variables(norm)
    tgen = initialize_model(_cfg(norm))
    tgen.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, v)), strict=True)
    return jgen, v, tgen.eval()


def _x(hw, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (1,) + hw + (3,)).astype(np.float32)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_f32_generator_matches_jax(norm, hw):
    """Tolerance 1e-4 on the tanh output: both run float32 on the CPU and
    differ in the convolutions' summation order (measured 8e-6)."""
    jgen, v, tgen = _pair(norm)
    x = _x(hw)
    want = np.asarray(jgen.apply(v, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = tgen(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1,) + hw + (3,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_bf16_generator_matches_jax(norm, hw, monkeypatch):
    """compute_dtype bf16 on both sides, the JAX blocks through its Pallas
    kernel in interpret mode (set and restored as
    tests/test_resblock_pallas.py:97-110 does), the port's through K3's
    plain version. Bounds: max 0.06, mean 0.01 on the tanh output (measured
    0.025 and 0.0033 with instance norm). With batch norm the float32
    running statistics promote everything after the first norm to float32
    in both (the first conv is the only bf16 layer), and the blocks are not
    fused: measured 4e-6."""
    jgen, v, tgen = _pair(norm)
    x = _x(hw)
    rp.set_enabled(True)
    rp.set_force_interpret(True)
    try:
        want = np.asarray(JWrappedNet(module=jgen, compute_dtype=jnp.bfloat16)
                          .apply(v, jnp.asarray(x), train=False))
    finally:
        rp.set_enabled(False)
        rp.set_force_interpret(False)
    calls = []
    plain = resblock.fused_resblock

    def counting(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(resblock, "fused_resblock", counting)
    with torch.inference_mode():
        got = WrappedNet(module=tgen, compute_dtype=torch.bfloat16).apply(
            torch.from_numpy(x))
    assert len(calls) == (2 if norm == "instance" else 0)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    d = np.abs(got.float().numpy() - want.astype(np.float32))
    assert d.max() < 0.06 and d.mean() < 0.01


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_state_dict_loads_into_jax(norm):
    """A port state_dict goes into the JAX generator through the JAX
    package's own importer, every leaf filled, and gives the same output."""
    jgen, _ = _jax_variables(norm)
    template = jax.tree_util.tree_map(np.asarray, jgen.init(
        jax.random.PRNGKey(9), jnp.zeros((1, 64, 64, 3)), train=False))
    tgen = initialize_model(_cfg(norm))
    initialize_weights(tgen, "kaiming_p2p", seed=5)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, b in tgen.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    state = {k: v.numpy() for k, v in tgen.state_dict().items()}
    variables = ti.convert_torch_state(template, state, min_coverage=1.0)
    x = _x((64, 64), seed=1)
    want = np.asarray(jgen.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = tgen.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    back = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k].numpy(), state[k])


def _layer_stats(named):
    """{torch name: (mean, std, count)} of every float parameter."""
    return {k: (float(a.mean()), float(a.std()), a.numel())
            for k, a in named}


@pytest.mark.parametrize("scheme", ["normal_p2p", "kaiming_p2p"])
def test_init_matches_jax_scheme(scheme):
    """Per layer the same distribution as the JAX package's init: conv and
    transposed-conv weights of the same std (gain 0.2, or sqrt(2 / fan_in)
    with the JAX kernel's fan_in), zero biases, BatchNorm scale N(1, 0.2)."""
    jgen = j_initialize_model(_cfg("batch"))
    v = jgen.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                  train=False)
    jp = j_initialize_weights(v["params"], jax.random.PRNGKey(1),
                              weights=scheme)
    want = _layer_stats(from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jp)}).items())
    tgen = initialize_weights(initialize_model(_cfg("batch")), scheme, seed=2)
    got = _layer_stats((k, p.detach())
                       for k, p in tgen.named_parameters())
    assert sorted(got) == sorted(want)
    for k, (m, s, n) in got.items():
        wm, ws, _ = want[k]
        if k.endswith("bias"):
            assert m == s == wm == ws == 0, k
            continue
        # two independent samples of n: 5 standard errors of the difference
        assert abs(s - ws) < 5 * ws / np.sqrt(n), (k, s, ws)
        assert abs(m - wm) < 5 * ws * np.sqrt(2.0 / n), (k, m, wm)
        if k.startswith("model.2.") or k.endswith("conv_block.2.weight"):
            assert abs(m - 1) < 5 * 0.2 / np.sqrt(n), (k, m)  # BN scale


@pytest.mark.parametrize("entry,norm,std", [
    ("cyclegan", "instance", 0.2), ("hedngan", "batch", None)])
def test_hub_generators_build(entry, norm, std):
    """The hub's choices: cyclegan is instance norm with normal_p2p (gain
    0.2); hedngan, not pretrained, is the reference's batch-norm default
    with kaiming_p2p. Full width, 9 blocks, on the CPU."""
    model = getattr(thub, entry)(pretrained=False, device="cpu")
    net = model.net.module
    assert model.net.data_params == thub.GENERATOR_DATA
    assert "pooling" not in model.meta and model.meta["out_channels"] == 3
    norms = {type(m).__name__ for m in net.modules()}
    assert ("BatchNorm" in norms) == (norm == "batch")
    assert ("InstanceNorm" in norms) == (norm == "instance")
    w = net.model[1].weight.detach()
    want = std or np.sqrt(2.0 / w[0].numel())
    assert abs(float(w.std()) - want) < 0.05 * want
    w = net.model[19].weight.detach()  # ConvTranspose (I, O, 3, 3)
    want = std or np.sqrt(2.0 / (w.shape[0] * 9))
    assert abs(float(w.std()) - want) < 0.05 * want
    assert len([m for m in net.modules()
                if type(m).__name__ == "ResnetBlock"]) == 9
    x = _x((32, 32), seed=2)
    with torch.inference_mode():
        y = model(x)
    assert y.shape == (1, 32, 32, 3) and bool(torch.isfinite(y).all())
    assert float(y.abs().max()) <= 1.0


def test_hub_loads_local_checkpoint(tmp_path):
    """pretrained=True reads a reference-layout file (flat dict with
    `model_state`) from a local path, strictly; URLs are refused."""
    src = thub.cyclegan(pretrained=False, device="cpu")
    state = {k: v.clone() + 0.5 for k, v in
             src.net.module.state_dict().items()}
    ckpt = tmp_path / "generator.pth"
    torch.save({"type": "official_resnet_generator", "model_state": state},
               ckpt)
    m = thub.hedngan(pretrained=True, device="cpu", checkpoint=str(ckpt))
    loaded = m.net.module.state_dict()
    assert sorted(loaded) == sorted(state)
    for k, v in loaded.items():
        assert torch.equal(v, state[k]), k
    with pytest.raises(ValueError, match="local file"):
        thub.cyclegan(pretrained=True, device="cpu",
                      checkpoint=thub.BASE_URL + "cyclegan_generator_X.pth")


def test_compute_dtype_keeps_one_cast_copy():
    """The bf16 copy is made once and remade only when a weight changes;
    BatchNorm's running statistics stay float32 in it."""
    _, _, tgen = _pair("batch")
    net = WrappedNet(module=tgen, compute_dtype=torch.bfloat16)
    first = net.compute_module()
    assert net.compute_module() is first and first is not tgen
    assert first.model[1].weight.dtype == torch.bfloat16
    assert first.model[2].weight.dtype == torch.bfloat16
    assert first.model[2].running_mean.dtype == torch.float32
    assert tgen.model[1].weight.dtype == torch.float32
    with torch.no_grad():
        tgen.model[1].weight.mul_(2)
    again = net.compute_module()
    assert again is not first
    assert torch.equal(again.model[1].weight,
                       tgen.model[1].weight.to(torch.bfloat16))
