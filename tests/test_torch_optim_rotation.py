"""A micro HED^N-GAN (tests/torch_gan_common.py) whose optimizers rotate
(`composition: {alternate_iteration: 2, order: generator_X,
discriminator_Y,detector}`) and whose detector trains with SGD, stepped
by the port's build and by the JAX package's on the CPU from the same
weights on the same batches: each step trains the active member alone in
both, the two runs agree within the Adam reach of tests/torch_gan_common,
and the rotation's phase survives a resume."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.scenarios import build as jbuild
from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.utils import weights as W
from test_torch_optim_options import _batches
from torch_gan_common import adam_reach, micro_config, shape_init, \
    without_data

torch.set_num_threads(1)

ROTATION = {"alternate_iteration": 2,
            "order": "generator_X,discriminator_Y,detector"}
STEPS = 6       # each member of the rotation active twice


def _rotation_cfg(root):
    cfg = micro_config(root)
    opt = cfg["learning"]["training"]["optimizer"]
    opt["detector"] = {"algorithm": "sgd", "lr": 1e-3, "momentum": 0.9,
                       "weight_decay": 2e-4}
    opt["composition"] = dict(ROTATION)
    return cfg


@pytest.fixture(scope="module")
def rotation(tmp_path_factory):
    """The JAX and the port build of a micro HED^N-GAN with the rotation
    and an SGD detector, STEPS steps each from the same weights on the
    same batches: the parameters after each step."""
    cfg = _rotation_cfg(str(tmp_path_factory.mktemp("rotation")))
    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        jexp = jbuild.build_gan_experiment(without_data(cfg), sample_hw=32)
    exp = build_gan_experiment(without_data(cfg), device="cpu")
    host = jax.tree_util.tree_map(np.asarray, jexp["variables"])
    for name, sd in W.from_jax_variables(host).items():
        exp["models"][name].module.load_state_dict(sd, strict=True)
    names = ("generator_X", "discriminator_Y", "detector")
    out = {"jax": [], "port": [], "exp": exp, "init": {
        n: dict(exp["models"][n].module.named_parameters()) for n in names}}
    out["init"] = {n: {k: p.detach().clone() for k, p in ps.items()}
                   for n, ps in out["init"].items()}
    jstate, state = jexp["state"], exp["state"]
    for X, Y in _batches(STEPS):
        jstate, jm, _ = jexp["step"](jstate, jnp.asarray(X), jnp.asarray(Y))
        jp = W.from_jax_variables(jax.tree_util.tree_map(
            np.asarray, jstate.variables))
        out["jax"].append((jax.tree_util.tree_map(float, jm), jp))
        state, m, _ = exp["step"](state, torch.from_numpy(X),
                                  torch.from_numpy(Y))
        out["port"].append(({k: float(v) for k, v in m.items()}, {
            n: {k: p.detach().clone() for k, p in
                exp["models"][n].module.named_parameters()}
            for n in names}))
    out["state"] = state
    return out


def test_rotation_moves_only_the_active_member(rotation):
    """Step t trains member (t // 2) % 3 of the order alone: its
    parameters move, the others' stay bit for bit, in the port and in the
    JAX package."""
    names = ("generator_X", "discriminator_Y", "detector")
    prev_p, prev_j = rotation["init"], {
        n: {k: v for k, v in rotation["init"][n].items()} for n in names}
    for t, ((_, jp), (_, pp)) in enumerate(zip(rotation["jax"],
                                               rotation["port"])):
        active = names[(t // 2) % 3]
        for n in names:
            moved_p = any(not torch.equal(pp[n][k], prev_p[n][k])
                          for k in pp[n])
            moved_j = any(not torch.equal(jp[n][k], prev_j[n][k])
                          for k in pp[n])
            assert moved_p == moved_j == (n == active), (t, n)
        prev_p = pp
        prev_j = {n: {k: jp[n][k] for k in pp[n]} for n in names}
    gates = rotation["state"].optimizers
    assert all(g.count == STEPS for g in gates.values())
    assert isinstance(gates["detector"].optimizer, torch.optim.SGD)


def test_rotation_against_jax(rotation):
    """Each step's metrics within tests/test_gan_step_golden.py's bound of
    JAX's; each Adam member within 2 lr x adam_reach of its active steps
    of JAX's, the SGD detector within 1% of its own movement (it trains
    last, on a generator that Adam moved apart by rounding)."""
    exp = rotation["exp"]
    for (jm, jp), (pm, pp) in zip(rotation["jax"], rotation["port"]):
        for k in pm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=2e-3, atol=2e-4,
                                       err_msg=k)
    (_, jp), (_, pp) = rotation["jax"][-1], rotation["port"][-1]
    for name in ("generator_X", "discriminator_Y"):
        lrs = {id(p): g["lr"] for g in exp["optimizers"][name].param_groups
               for p in g["params"]}
        params = dict(exp["models"][name].module.named_parameters())
        for k, got in pp[name].items():
            bound = 2 * lrs[id(params[k])] * adam_reach(2, 0.5)
            diff = float((got.double() - jp[name][k].double()).abs().max())
            assert diff <= bound, (name, k, diff, bound)
    for k, got in pp["detector"].items():
        moved = float((got - rotation["init"]["detector"][k]).abs().max())
        diff = float((got.double() - jp["detector"][k].double()).abs().max())
        assert diff <= 0.01 * moved + 1e-7, (k, diff, moved)


def _params(exp):
    return {n: {k: v.clone() for k, v in m.module.state_dict().items()}
            for n, m in exp["models"].items()}


def test_rotation_resumes_in_phase(tmp_path):
    """The gates' counts travel with the GAN state: a build that takes
    the nets and the state after step 3 repeats steps 4 to 6 of the
    straight run bit for bit."""
    cfg = without_data(_rotation_cfg(str(tmp_path)))
    batches = [tuple(torch.from_numpy(a) for a in b)
               for b in _batches(STEPS)]
    straight = build_gan_experiment(cfg, device="cpu")
    first = build_gan_experiment(cfg, device="cpu")
    state, st1 = straight["state"], first["state"]
    for t, (X, Y) in enumerate(batches):
        state, _, _ = straight["step"](state, X, Y)
        if t < 3:
            st1, _, _ = first["step"](st1, X, Y)
    resumed = build_gan_experiment(cfg, device="cpu")
    for name, sd in _params(first).items():
        resumed["models"][name].module.load_state_dict(sd)
    st2 = resumed["state"]
    st2.load_state_dict(copy.deepcopy(st1.state_dict()))
    assert [g.count for g in st2.optimizers.values()] == [3] * 3
    for X, Y in batches[3:]:
        st2, _, _ = resumed["step"](st2, X, Y)
    want, got = _params(straight), _params(resumed)
    for name in want:
        for k in want[name]:
            assert torch.equal(got[name][k], want[name][k]), (name, k)
