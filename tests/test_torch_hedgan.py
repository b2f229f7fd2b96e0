"""The port's HED-GAN training (learning/gan_steps.py::build_hedgan_step,
scenarios/build.py's hedgan family: train_hedngan.yml with the teacher,
the detector's optimizer and schedule deleted by train_hedgan.yml) against
the JAX package's, on the CPU: hedgan.yml's `train` target through both
packages' run_target at micro size (tests/torch_gan_common.py: ngf 4 with
one block, ndf 4, HED at width 0.0625, batches of two 32x32 crops, 2
epochs of 4 steps), then two steps of each from the same weights."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_finetune_loop import _listing
from test_torch_gan_train import _history
from torch_gan_common import (ROOT, SIDE, adam_reach,
                              train_target_pair, without_data)

torch.set_num_threads(1)

HEDGAN_YML = os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs",
                          "iccv23", "train", "hedgan.yml")
METRICS = ("total", "D_real", "D_fake", "G_gan", "G_hed")
RTOL = 1e-3     # per-epoch means of the metrics and weight norms


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _micro(section):
    # the JAX package would compile a scan of 8 steps besides the step
    section["learning"]["training"]["dispatch_chunk"] = 0
    section["sample_hw"] = SIDE     # the JAX package's init shape


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hedgan"))
    out = train_target_pair(HEDGAN_YML, root, _micro)
    exp = build_gan_experiment(without_data(out["section"]), device="cpu")
    jexp = out["jexp"]
    jstate, state = jexp["state"], exp["state"]
    out["init"] = {name: {k: v.clone() for k, v in
                          net.module.state_dict().items()}
                   for name, net in exp["models"].items()}
    rs = np.random.RandomState(0)
    out["steps"] = []
    for _ in range(2):
        X, Y = (rs.uniform(-1, 1, (2, SIDE, SIDE, 3)).astype(np.float32)
                for _ in range(2))
        jstate, jm, jdbg = jexp["step"](jstate, jnp.asarray(X),
                                        jnp.asarray(Y))
        state, m, dbg = exp["step"](state, torch.from_numpy(X),
                                    torch.from_numpy(Y))
        out["steps"].append((
            {k: float(v) for k, v in _host(jm).items()},
            from_jax_variables(_host(jstate.variables)),
            {k: float(v) for k, v in m.items()},
            {name: {k: v.clone() for k, v in
                    net.module.state_dict().items()}
             for name, net in exp["models"].items()}, dbg, _host(jdbg)))
    out["exp"] = exp
    return out


def test_build_follows_train_hedgan(runs):
    """train_hedgan.yml's deletions: no teacher, no optimizer or schedule
    for the detector, which does not train (no `frozen` flag: its file is
    written every epoch, as in the JAX package)."""
    exp = runs["exp"]
    assert sorted(exp["models"]) == ["detector", "discriminator_Y",
                                     "generator_X"]
    assert sorted(exp["optimizers"]) == ["discriminator_Y", "generator_X"]
    assert sorted(exp["schedules"]) == ["discriminator_Y", "generator_X"]
    assert exp["family"] == "hedgan"
    assert all(p.requires_grad for p in
               exp["models"]["detector"].module.parameters())


@pytest.mark.parametrize("n", [1, 2])
def test_steps_against_jax(runs, n):
    """After n steps: each metric within rtol 2e-3 / atol 2e-4 of JAX's,
    G's and D's parameters within 2 lr per Adam step (adam_reach), every
    BatchNorm statistic within 1e-5, the detector unchanged; the edge
    maps of the debug dict within 1e-4."""
    jm, jv, pm, pv, dbg, jdbg = runs["steps"][n - 1]
    assert sorted(pm) == sorted(jm) == sorted(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(pm[k], jm[k], rtol=2e-3, atol=2e-4,
                                   err_msg=k)
    for name in ("generator_X", "discriminator_Y"):
        (group,) = runs["exp"]["optimizers"][name].param_groups
        bound = 2 * group["lr"] * adam_reach(n, group["betas"][0])
        for key, want in jv[name].items():
            if key.endswith("num_batches_tracked"):
                continue
            diff = float((pv[name][key].double() - want.double()).abs()
                         .max())
            tol = 1e-5 if key.endswith(("running_mean", "running_var")) \
                else bound
            assert diff <= tol, (name, key, diff)
    for key, want in runs["init"]["detector"].items():
        assert torch.equal(pv["detector"][key], want), key
    for k in ("real_E", "fake_E", "fake_Y"):
        assert dbg[k].shape == jdbg[k].shape
        np.testing.assert_allclose(dbg[k].numpy(), jdbg[k], rtol=0,
                                   atol=1e-4, err_msg=k)


def test_train_target_against_jax(runs):
    """hedgan.yml's `train` target: the same event keys each epoch, each
    per-epoch mean within RTOL of JAX's, the same checkpoint and blob
    files (the edge maps' samples among them), the same stage metadata
    keys, metrics and best epoch."""
    jh, ph = _history(runs["jdir"]), _history(runs["pdir"])
    assert [e["epoch"] for e in ph] == [e["epoch"] for e in jh] == [1, 2]
    for je, pe in zip(jh, ph):
        assert sorted(pe["metrics"]) == sorted(je["metrics"])
        for k, v in je["metrics"].items():
            np.testing.assert_allclose(pe["metrics"][k], v, rtol=RTOL,
                                       err_msg=k)
    for k in METRICS:
        assert "train/learning/" + k in ph[0]["metrics"]
    got, want = _listing(runs["pdir"]), _listing(runs["jdir"])
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if v} == \
        {k: v for k, v in want.items() if v}
    for name in ("data/real_E/image0.chan1", "data/fake_E/image0.chan1",
                 "val/visual/v0"):
        assert "blobs/%s_epoch_01.jpg" % name.replace("/", "_") in got
    jmeta = runs["jax"]["1_train_augment"]
    pmeta = runs["port"]["1_train_augment"]
    assert list(runs["port"]) == list(runs["jax"])
    assert sorted(pmeta) == sorted(jmeta)
    assert pmeta["best_epoch"] == jmeta["best_epoch"] == 2
    assert sorted(pmeta["metrics"]) == sorted(jmeta["metrics"])
    for k, v in jmeta["metrics"].items():
        np.testing.assert_allclose(pmeta["metrics"][k], v, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["hedgan", "rcfgan", "rcfngan", "cut"])
def test_chip_smoke_family_cuts(family):
    """chip_smoke's run_gan_families runs each family's `train` target as
    shipped (full width, batch and crop, dispatch_chunk), cut only as
    FAMILY_CUTS says: epochs, the decay epochs, checkpoint and validation
    frequencies, the pairs an epoch and the detectors' local files."""
    import chip_smoke
    from gandtr_tpu_torch.scenarios.engine import load_yaml_scenario
    pth = {"hed": "/r/hed.pth", "rcf": "/r/rcf.pth"}
    yml = chip_smoke.FAMILY_YML[family]
    got = load_yaml_scenario([yml] + chip_smoke.family_overrides(
        family, pth))["train"]["1_train_augment"]
    want = load_yaml_scenario([yml])["train"]["1_train_augment"]
    cuts = chip_smoke.FAMILY_CUTS[family]
    lt = want["learning"]["training"]
    lt["epochs"] = cuts["epochs"]
    for name in cuts["schedulers"]:
        lt["scheduler"][name]["n_epochs_decay"] = 1
    assert sorted(cuts["schedulers"]) == sorted(
        k for k, v in lt["scheduler"].items() if v)
    want["learning"]["checkpoints"].update(checkpoint_every=1,
                                           store_every=2)
    want["learning"]["validation"]["visual"]["frequency"] = 1
    want["data"]["train"]["dataset"]["size"] = cuts["size"]
    for member, kind in cuts["detectors"].items():
        want["network"][member]["model"]["pretrained"] = pth[kind]
    assert got == want
    assert lt["dispatch_chunk"] == 8
    assert want["data"]["train"]["loader"]["batch_size"] == (
        1 if family == "cut" else 10)
    if family.startswith("rcf"):
        assert want["network"]["detector"]["model"]["architecture"] == "rcf"
