"""The port's SGD, optimizer alternation and path-form (warm start)
NetworkSet members against the JAX package's, on the CPU: SGD against
optax's chain on cirnet's and HED's parameter groups, the rotation's
arithmetic, the gate's untouched state, and `adopt_path_members` against
the JAX package's `_adopt_path_members`. A micro HED^N-GAN trained with a
rotation is tests/test_torch_optim_rotation.py."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.learning import optimizers as jopt
from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.scenarios import build as jbuild
from gandtr_tpu_torch.learning import optimizers as popt
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.scenarios.build import (adopt_path_members,
                                              build_gan_experiment)
from gandtr_tpu_torch.utils import weights as W
from torch_gan_common import micro_config, seeded_variables, without_data

torch.set_num_threads(1)

MODELS = {
    "cirnet": {"architecture": "cirnet", "cir_architecture": "vgg16",
               "pooling": "gem", "local_whitening": False,
               "whitening": False},
    "hed_interpolation": {"architecture": "hed_interpolation",
                          "width_mult": 0.0625},
}


@functools.lru_cache(maxsize=None)
def _seeded(arch):
    """(JAX variables, the same as a port state dict, a seeded gradient
    tree)."""
    jmod = j_initialize_model(dict(MODELS[arch]))
    shapes = jax.eval_shape(lambda x: jmod.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, 32, 32, 3)))
    v = seeded_variables(dict(shapes), 3)
    if arch == "cirnet":
        v["params"]["gem_p"] = np.full(v["params"]["gem_p"].shape, 3.0,
                                       np.float32)
    rs = np.random.RandomState(7)
    grads = jax.tree_util.tree_map(
        lambda a: rs.standard_normal(a.shape).astype(np.float32),
        v["params"])
    return v, W.from_jax_variables(v), grads


def _models(arch):
    """(JAX variables, port module) with the same seeded weights."""
    v, sd, _ = _seeded(arch)
    module = initialize_model(dict(MODELS[arch]))
    module.load_state_dict(sd, strict=True)
    return v, module


@pytest.mark.parametrize("arch,momentum,weight_decay", [
    ("cirnet", 0.0, 0.0), ("cirnet", 0.9, 5e-4),
    ("hed_interpolation", 0.0, 0.0), ("hed_interpolation", 0.9, 0.0),
    ("hed_interpolation", 0.0, 5e-4), ("hed_interpolation", 0.9, 5e-4)])
def test_sgd_against_optax(arch, momentum, weight_decay):
    """Three SGD steps on the same gradients, the architecture's parameter
    groups (lr and decay multipliers) on both sides: torch's decay, then
    momentum, then lr is optax's decay, trace, lr, within 1e-6."""
    v, module = _models(arch)
    cfg = {"algorithm": "sgd", "lr": 1e-3, "momentum": momentum,
           "weight_decay": weight_decay}
    opt, base = popt.initialize_optimizer(dict(cfg),
                                          module.named_parameters(), arch)
    assert isinstance(opt, torch.optim.SGD) and base == 1e-3
    assert all(g["dampening"] == 0 and not g["nesterov"]
               for g in opt.param_groups)
    tx, _ = jopt.initialize_optimizer(
        dict(cfg), group_mults=jopt.param_group_mults(arch, v["params"]))
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = tx.init(params)

    @jax.jit
    def update(grads, state, params):
        upd, state = tx.update(grads, state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, upd), state

    g0 = _seeded(arch)[2]
    gsd = W.from_jax_variables({"params": g0})
    for t in range(3):
        # a different gradient each step: the seeded one, scaled
        scale = np.float32(1.0 - 0.6 * t)
        for k, p in module.named_parameters():
            p.grad = gsd[k] * scale
        opt.step()
        grads = jax.tree_util.tree_map(lambda g: jnp.asarray(g * scale), g0)
        params, state = update(grads, state, params)
    want = W.from_jax_variables({"params": params})
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [-3, -2, -1, 0, 1, 2, 3, None])
@pytest.mark.parametrize("k", [2, 3])
def test_alternation_active_against_jax(n, k):
    for t in range(24):
        for i in range(k):
            assert popt.alternation_active(t, i, k, n) == bool(
                jopt.alternation_active(t, i, k, n)), (t, i)


def _linear_adam(seed=0):
    torch.manual_seed(seed)
    lin = torch.nn.Linear(4, 3)
    return lin, torch.optim.Adam(
        [{"params": list(lin.parameters()), "lr": 0.1, "lr_mult": 1.0}],
        lr=0.1)


def test_gated_adam_is_untouched_while_inactive():
    """Member 1 of two, rotating every step: at t=0 and t=2 it does not
    step, so its parameters, its moments and Adam's step count stay as
    they were; at t=1 it steps as the bare Adam does."""
    lin, adam = _linear_adam()
    ref, ref_adam = _linear_adam()
    gate = popt.AlternationGate(adam, 1, 2, 1)
    x = torch.randn(5, 4)
    for t in range(3):
        before = [p.detach().clone() for p in lin.parameters()]
        state = copy.deepcopy(adam.state_dict()["state"])
        gate.zero_grad()
        lin(x).square().sum().backward()
        gate.step()
        if t % 2 == 0:
            assert all(torch.equal(a, p) for a, p in zip(before,
                                                          lin.parameters()))
            assert str(adam.state_dict()["state"]) == str(state)
        else:
            ref_adam.zero_grad()
            ref(x).square().sum().backward()
            ref_adam.step()
            assert all(torch.equal(a, b) for a, b in zip(ref.parameters(),
                                                          lin.parameters()))
    assert gate.count == 3
    assert int(adam.state_dict()["state"][0]["step"]) == 1


def test_gate_state_dict_keeps_the_phase():
    lin, adam = _linear_adam()
    gate = popt.AlternationGate(adam, 0, 3, 2)
    for _ in range(5):
        gate.step()
    saved = gate.state_dict()
    other = popt.AlternationGate(_linear_adam()[1], 0, 3, 2)
    other.load_state_dict(saved)
    assert other.count == 5 and other.active() == gate.active()


def test_set_learning_rate_reaches_the_gated_optimizer():
    _, module = _models("hed_interpolation")
    opt, base = popt.initialize_optimizer(
        {"algorithm": "sgd", "lr": 1e-3, "momentum": 0.9},
        module.named_parameters(), "hed_interpolation")
    gated = popt.alternate({"detector": opt, "other": _linear_adam()[1]},
                           {"alternate_iteration": 2,
                            "order": "other,detector"})["detector"]
    popt.set_learning_rate(gated, base, 0.5)
    assert sorted({(g["lr_mult"], g["lr"]) for g in opt.param_groups}) == \
        sorted({(m, base * m * 0.5) for m in
                (1.0, 2.0, 100.0, 200.0, 0.01, 0.02, 0.001, 0.002)})


def test_alternate_refuses_an_order_that_misses_an_optimizer():
    opts = {"a": _linear_adam()[1], "b": _linear_adam()[1]}
    assert popt.alternate(opts, {"alternate_iteration": 1}) == opts
    with pytest.raises(ValueError, match="order"):
        popt.alternate(opts, {"alternate_iteration": 2, "order": "a,c"})


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [tuple(rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
                  for _ in range(2)) for _ in range(n)]


def _network_file(path, cfg, module):
    torch.save({"type": "SingleNetwork", "frozen": False,
                "network_params": {"model": cfg["model"],
                                   "runtime": cfg["runtime"]},
                "model_state": module.state_dict()}, path)


@pytest.mark.parametrize("runtime", ["load_from_checkpoint",
                                     {"frozen": "load_from_checkpoint",
                                      "wrappers": ""}])
def test_path_member_against_jax(tmp_path, runtime):
    """A `path:` member: the rewritten config equals the JAX package's
    `_adopt_path_members`, the staged state equals the file's, and the
    build's member starts from the file's weights."""
    cfg = micro_config(str(tmp_path))
    gen_cfg = cfg["network"]["generator_X"]
    donor = build_gan_experiment(without_data(cfg), device="cpu")
    src = donor["models"]["generator_X"].module
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
    path = str(tmp_path / "generator_X.pth")
    _network_file(path, gen_cfg, src)
    member = {"path": path, "runtime": runtime,
              "initialize": {"weights": "kaiming_p2p", "seed": 1}}
    pnet = {"generator_X": copy.deepcopy(member)}
    jnet = {"generator_X": copy.deepcopy(member)}
    pstates = adopt_path_members(pnet)
    jstates = jbuild._adopt_path_members(jnet)
    assert pnet == jnet
    assert sorted(pstates["generator_X"]) == sorted(jstates["generator_X"])
    for k, v in pstates["generator_X"].items():
        assert np.array_equal(v.numpy(), np.asarray(jstates["generator_X"][k]))
    warm = copy.deepcopy(cfg)
    warm["network"]["generator_X"] = copy.deepcopy(member)
    exp = build_gan_experiment(without_data(warm), device="cpu")
    got = exp["models"]["generator_X"].module.state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k
    X, Y = (torch.from_numpy(a) for a in _batches(1)[0])
    _, m, _ = exp["step"](exp["state"], X, Y)
    assert np.isfinite(float(m["total"]))


def test_path_member_refusals(tmp_path):
    cfg = micro_config(str(tmp_path))
    with pytest.raises(NotImplementedError, match="downloads nothing"):
        adopt_path_members({"g": {"path": "http://host/g.pth"}})
    donor = build_gan_experiment(without_data(cfg), device="cpu")
    path = str(tmp_path / "g.pth")
    _network_file(path, cfg["network"]["generator_X"],
                  donor["models"]["generator_X"].module)
    other = dict(cfg["network"]["generator_X"]["model"], ngf=8)
    with pytest.raises(ValueError, match="differs from its file"):
        adopt_path_members({"g": {"path": path, "model": other}})
