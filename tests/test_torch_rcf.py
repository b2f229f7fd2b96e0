"""The port's RCF edge detector (models/rcf.py) and the RCF-GAN and
RCF^N-GAN steps against the JAX package's, on the CPU.

RCF runs at full width (it has no width knob in either package) on
37x45 images, where a wrong crop offset or pool rounding shows; its
weights cross by from_jax_variables and back by the JAX package's
importer. The GAN steps run rcfgan.yml's and rcfngan.yml's
train sections (the RCF wrappers rgb2bgr_pre and two meanstd_pre on each
detector) with the generator and discriminator cut as
tests/torch_gan_common.py cuts them, on batches of two 32x32 images."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.models import initialize_model as j_model
from gandtr_tpu.scenarios.build import build_gan_experiment as j_build
from gandtr_tpu.scenarios.engine import load_yaml_scenario
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.utils.weights import from_jax_variables
from torch_gan_common import (ROOT, SIDE, adam_reach, micro_section,
                              seeded_variables, shape_init, without_data)

torch.set_num_threads(1)

TRAIN = os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs", "iccv23",
                     "train")


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def rcf():
    """The JAX RCF with seeded values, and the port's with the same
    weights (a local .pth through the config's `pretrained:`)."""
    jm = j_model({"architecture": "rcf"})
    x = jnp.zeros((1, 37, 45, 3))
    v = jax.tree_util.tree_map(jnp.asarray, seeded_variables(dict(
        jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), x)), 1))
    return jm, v


def test_weights_round_trip_and_load(rcf, tmp_path):
    """from_jax_variables names every parameter as the reference does
    (13 convs, 13 downs, 5 score_dsn, score_fuse; the bilinear kernels
    are not state); the JAX importer with rcf_key_map takes the state
    back to the same values; a seeded local .pth loads strictly through
    `pretrained:`."""
    from gandtr_tpu_torch.learning.network import build_single_net
    from gandtr_tpu_torch.utils.weights import load_pretrained
    jm, v = rcf
    sd = from_jax_variables(_host(v))
    assert len(sd) == 2 * (13 + 13 + 5 + 1)
    assert {"conv5_3.weight", "conv5_3_down.bias", "score_dsn5.weight",
            "score_fuse.weight"} <= set(sd)
    back = ti.convert_torch_state(
        _host(v), {k: t.numpy() for k, t in sd.items()},
        key_map=ti.key_map_for_architecture("rcf"), strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_host(v))):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    path = str(tmp_path / "rcf_seeded.pth")
    torch.save(sd, path)
    net = build_single_net({"model": {"architecture": "rcf",
                                      "pretrained": path}})
    load_pretrained(net.module, path)
    got = net.module.state_dict()
    assert sorted(got) == sorted(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert net.module.deconv16.shape == (1, 1, 16, 16)


@pytest.mark.parametrize("no_sigmoid", [False, True])
def test_forward_against_jax(rcf, no_sigmoid):
    """The edge map at 37x45 within 2e-5 of JAX's, the pre-sigmoid map
    within 2e-4; the output has the input's size."""
    jm, v = rcf
    pm = initialize_model({"architecture": "rcf"})
    pm.load_state_dict(from_jax_variables(_host(v)), strict=True)
    hw = (37, 45)
    x = np.random.RandomState(hw[0]).uniform(-1, 1, (2,) + hw + (3,)) \
        .astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), no_sigmoid=no_sigmoid))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), no_sigmoid=no_sigmoid).numpy()
    assert got.shape == want.shape == (2,) + hw + (1,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 if no_sigmoid else 2e-5)


def _family_runs(yml, root, steps):
    """The yml's train section at micro size (RCF at full width), built by
    both packages from the same weights; `steps` steps of each on seeded
    batches: [(JAX metrics, JAX state dicts, port metrics, port state
    dicts)] and the port's experiment."""
    sec = load_yaml_scenario([os.path.join(TRAIN, yml)])["train"][
        "1_train_augment"]
    sec = without_data(micro_section(sec, root))
    sec["learning"]["training"]["dispatch_chunk"] = 0
    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        jexp = j_build(sec, sample_hw=SIDE)
    exp = build_gan_experiment(sec, device="cpu")
    for name, sd in from_jax_variables(_host(jexp["variables"])).items():
        exp["models"][name].module.load_state_dict(sd, strict=True)
    init = {name: {k: v.clone() for k, v in net.module.state_dict().items()}
            for name, net in exp["models"].items()}
    jstate, state = jexp["state"], exp["state"]
    rs = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        X, Y = (rs.uniform(-1, 1, (2, SIDE, SIDE, 3)).astype(np.float32)
                for _ in range(2))
        jstate, jm, _ = jexp["step"](jstate, jnp.asarray(X), jnp.asarray(Y))
        state, m, _ = exp["step"](state, torch.from_numpy(X),
                                  torch.from_numpy(Y))
        out.append(({k: float(v) for k, v in _host(jm).items()},
                    from_jax_variables(_host(jstate.variables)),
                    {k: float(v) for k, v in m.items()},
                    {name: {k: v.clone() for k, v in
                            net.module.state_dict().items()}
                     for name, net in exp["models"].items()}))
    return out, exp, init


@pytest.fixture(scope="module")
def rcfgan(tmp_path_factory):
    return _family_runs("rcfgan.yml", str(tmp_path_factory.mktemp("rg")), 1)


@pytest.fixture(scope="module")
def rcfngan(tmp_path_factory):
    return _family_runs("rcfngan.yml", str(tmp_path_factory.mktemp("rng")),
                        2)


def _check(runs, n, trained, fixed):
    """Metrics within rtol 2e-3 / atol 2e-4, the trained networks within
    2 lr per Adam step (adam_reach, each group's lr), BatchNorm statistics
    within 1e-5 after step 1 and 1e-4 after later steps (whose forwards
    run on parameters held only within 2 lr a step: 4e-5 of drift seen),
    the `fixed` networks unchanged."""
    steps, exp, init = runs
    jm, jv, pm, pv = steps[n - 1]
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=2e-3, atol=2e-4,
                                   err_msg=k)
    for name in trained:
        opt = exp["optimizers"][name]
        lr = {}
        for g in opt.param_groups:
            for p in g["params"]:
                lr[id(p)] = 2 * g["lr"] * adam_reach(n, g["betas"][0])
        params = dict(exp["models"][name].module.named_parameters())
        for key, want in jv[name].items():
            if key.endswith("num_batches_tracked"):
                continue
            diff = float((pv[name][key].double() - want.double()).abs()
                         .max())
            tol = lr[id(params[key])] if key in params \
                else (1e-5 if n == 1 else 1e-4)
            assert diff <= tol, (name, key, diff, tol)
    for name in fixed:
        for key, want in init[name].items():
            assert torch.equal(pv[name][key], want), (name, key)


def test_rcfgan_step_against_jax(rcfgan):
    """One RCF-GAN step: HED-GAN's step with the RCF detector, which does
    not train."""
    _check(rcfgan, 1, ("generator_X", "discriminator_Y"), ("detector",))
    assert sorted(rcfgan[2]) == ["detector", "discriminator_Y",
                                 "generator_X"]


@pytest.mark.parametrize("n", [1, 2])
def test_rcfngan_steps_against_jax(rcfngan, n):
    """Two RCF^N-GAN steps: the RCF student (and its optimizer's groups:
    RCF has none) trains, its RCF teacher stays; E_real is exactly 0 at
    step 1 (the student starts as its teacher)."""
    _check(rcfngan, n, ("generator_X", "discriminator_Y", "detector"),
           ("detector_frozen",))
    if n == 1:
        assert rcfngan[0][0][2]["E_real"] == 0.0
    assert len(rcfngan[1]["optimizers"]["detector"].param_groups) == 1
