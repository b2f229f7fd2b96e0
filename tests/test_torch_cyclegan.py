"""The port's CycleGAN training (learning/gan_steps.py::build_cyclegan_step,
learning/image_pool.py, scenarios/build.py's cyclegan family) against the
JAX package's, on the CPU, on parameters/train_cyclegan.yml cut to micro
size (ngf 4 with one block, ndf 4, 32x32 crops, batches of 2, 2 epochs
of 4 steps with the decay in the second, checkpoint_every 1, store_every
2, the visual validation every epoch). The JAX nets start from seeded
values over their shapes (tests/torch_gan_common.py); the same values
reach the port through `from_jax_variables` and local `pretrained:`
files. The pools (50 images as shipped) never fill at this size, where
the two packages' pools agree exactly; the full pool's law is held on
its own."""
import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gandtr_tpu.scenarios.build as jbuild
from gandtr_tpu.learning import image_pool as jpool
from gandtr_tpu.scenarios.engine import load_yaml_scenario
from gandtr_tpu.scenarios.train_stage import train as j_train
from gandtr_tpu_torch import hub
from gandtr_tpu_torch.learning.image_pool import ImagePool
from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.scenarios.train_stage import train
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_finetune_loop import _listing
from test_torch_gan_train import _history, _same, _with_initial_weights
from torch_gan_common import (ROOT, SIDE, shape_init, without_data,
                              write_domain_set)

torch.set_num_threads(1)

TRAIN_CYCLEGAN = os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs",
                              "iccv23", "parameters", "train_cyclegan.yml")
RTOL = 1e-3     # per-epoch means of the metrics and weight norms
METRICS = ("total", "netG_X_total", "netG_Y_total", "netG_X_adversarial",
           "netG_X_cycle", "netG_Y_adversarial", "netG_Y_cycle",
           "netD_X_total", "netD_Y_total")


def micro_cyclegan_config(root, size=8, batch=2, epochs=2):
    cfg = load_yaml_scenario([TRAIN_CYCLEGAN])
    net = cfg["network"]
    for name in ("generator_X", "generator_Y"):
        net[name]["model"].update(ngf=4, n_blocks=1)
    for name in ("discriminator_X", "discriminator_Y"):
        net[name]["model"].update(ndf=4)
    lt = cfg["learning"]["training"]
    lt.update(epochs=epochs, parallel=False)
    for sched in lt["scheduler"].values():
        sched["n_epochs_decay"] = 1
    cfg["learning"]["checkpoints"].update(
        directory=os.path.join(root, "exp"), checkpoint_every=1,
        store_every=2)
    vis = cfg["learning"]["validation"]["visual"]
    vis["frequency"] = 1
    vdata = vis["criterion"]["data"]
    vdata["dataset"]["image_dir"] = os.path.join(root, "val")
    vdata["transforms"] = "pil2np | downscale:40 | totensor | normalize"
    lists = write_domain_set(root)
    cfg["data"]["train"]["dataset"].update(
        dataset_X=lists[0], dataset_Y=lists[1],
        image_dir=os.path.join(root, "ims") + "/*", size=size)
    cfg["data"]["train"]["loader"] = {"batch_size": batch, "num_workers": 0}
    cfg["data"]["train"]["transforms"] = \
        "pil2np | scalecrop:%d_%d:0.8_1 | totensor | normalize" % (SIDE, SIDE)
    cfg["output"]["learning"]["progress"]["print_each"] = 0
    cfg["sample_hw"] = SIDE     # the JAX pools' image side
    return cfg


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """The JAX train stage, then the port's from the JAX initial weights;
    one step of each on shared weights and a seeded batch."""
    root = str(tmp_path_factory.mktemp("cyclegan"))
    cfg = micro_cyclegan_config(root)
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        orig = jbuild.build_gan_experiment

        def recording(*args, **kwargs):
            exp = orig(*args, **kwargs)
            captured.setdefault("variables", exp["variables"])
            return exp
        mp.setattr(jbuild, "build_gan_experiment", recording)
        (jmeta,) = j_train(copy.deepcopy(cfg), ())
        jexp = orig(without_data(cfg), sample_hw=cfg["sample_hw"])
    pcfg = _with_initial_weights(cfg, root, captured["variables"])
    pcfg["learning"]["checkpoints"]["directory"] = os.path.join(root, "port")
    (pmeta,) = train(copy.deepcopy(pcfg), (), device="cpu")

    # one step from the same weights on the same batch
    rs = np.random.RandomState(0)
    X, Y = (rs.uniform(-1, 1, (2, SIDE, SIDE, 3)).astype(np.float32)
            for _ in range(2))
    jstate, jm, jdbg = jexp["step"](jexp["state"], jnp.asarray(X),
                                    jnp.asarray(Y))
    exp = build_gan_experiment(without_data(pcfg), device="cpu")
    state, pm, pdbg = exp["step"](exp["state"], torch.from_numpy(X),
                                  torch.from_numpy(Y))
    return {"root": root, "cfg": pcfg, "jmeta": jmeta, "pmeta": pmeta,
            "jdir": cfg["learning"]["checkpoints"]["directory"],
            "pdir": pcfg["learning"]["checkpoints"]["directory"],
            "step": {"jax": (_host(jm), _host(jdbg), jstate),
                     "port": (pm, pdbg, state, exp)}}


NETS = ("generator_X", "generator_Y", "discriminator_X", "discriminator_Y")
GRAD_RTOL = 1e-4    # a parameter's gradient, relative in the L2 norm
ZERO_GRAD = 1e-6    # a gradient that is 0 in exact arithmetic, relative to
#                     its network's (float32 leaves about 1e-8 there)
BETA1 = 0.5         # train_cyclegan.yml's Adam beta1, all four networks


def _adam_mu(opt_state):
    """The first moment of the optax Adam inside `opt_state`."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return adam.mu


def _gradients(jstate, exp):
    """{network: {torch name: (port's, JAX's)}}: each parameter's gradient
    in the step, read from Adam's first moment after its first step,
    (1 - beta1) g."""
    out = {}
    for name in NETS:
        mu = from_jax_variables({"params": _host(_adam_mu(
            jstate.opt_states[name]))})
        opt = exp["optimizers"][name]
        assert opt.param_groups[0]["betas"][0] == BETA1
        out[name] = {k: (opt.state[p]["exp_avg"] / (1 - BETA1),
                         mu[k] / (1 - BETA1))
                     for k, p in exp["models"][name].module.named_parameters()}
        assert sorted(out[name]) == sorted(mu), name
    return out


def test_one_step_against_jax(stages):
    """Each loss within 1e-3 relative, the fakes and reconstructions
    within 1e-4, the pools holding the same fakes. Each of the four
    networks' gradients (read from Adam's first moment), a parameter
    tensor at a time: within GRAD_RTOL of JAX's in the L2 norm, or, for
    the biases of the convolutions that an instance norm follows (their
    gradient is 0 in exact arithmetic), below ZERO_GRAD of the network's
    gradient in both packages. Then the updated weights: Adam's first step
    moves a weight by lr times g / (|g| + eps), so one more than 1.05 lr
    from JAX's took a gradient of the other sign; none may, off those
    biases."""
    jm, jdbg, jstate = stages["step"]["jax"]
    pm, pdbg, state, exp = stages["step"]["port"]
    assert sorted(pm) == sorted(jm) == sorted(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-3,
                                   err_msg=k)
    for k in ("fake_Y", "rec_X", "fake_X", "rec_Y"):
        np.testing.assert_allclose(pdbg[k].numpy(), jdbg[k], atol=1e-4,
                                   rtol=0, err_msg=k)
    for name in ("fake_X_pool", "fake_Y_pool"):
        pool, jp = state.pools[name], jstate.pools[name]
        assert pool.count == int(jp.count) == 2
        np.testing.assert_allclose(pool.images[:2].numpy(),
                                   np.asarray(jp.images)[:2], atol=1e-4,
                                   rtol=0, err_msg=name)
    jv = from_jax_variables(_host(jstate.variables))
    lr, n_zero = 2e-4, 0
    for name, grads in _gradients(jstate, exp).items():
        net = float(torch.cat([w.flatten() for _, w in grads.values()])
                    .norm())
        params = dict(exp["models"][name].module.named_parameters())
        for key, (got, want) in grads.items():
            if float(want.norm()) < ZERO_GRAD * net:
                assert float(got.norm()) < ZERO_GRAD * net, (name, key)
                n_zero += 1
                continue
            rel = float((got - want).norm() / want.norm())
            assert rel <= GRAD_RTOL, (name, key, rel)
            d = (params[key].detach() - jv[name][key]).abs()
            assert int((d > 1.05 * lr).sum()) == 0, (name, key)
    # the biases of the 7 + 7 normed generator convolutions (one block:
    # the stem, 2 down, 2 in the block, 2 up) and of the 3 + 3 normed
    # discriminator convolutions
    assert n_zero == 20


def test_train_stage_against_jax(stages):
    """The same event keys each epoch, each per-epoch mean within RTOL of
    JAX's; the same checkpoint and blob files; the stage metadata's keys
    and metrics as JAX's."""
    jh, ph = _history(stages["jdir"]), _history(stages["pdir"])
    assert [e["epoch"] for e in ph] == [e["epoch"] for e in jh] == [1, 2]
    for je, pe in zip(jh, ph):
        assert sorted(pe["metrics"]) == sorted(je["metrics"])
        for k, v in je["metrics"].items():
            np.testing.assert_allclose(pe["metrics"][k], v, rtol=RTOL,
                                       err_msg=k)
    for k in METRICS:
        assert "train/learning/" + k in ph[0]["metrics"]
    got, want = _listing(stages["pdir"]), _listing(stages["jdir"])
    assert sorted(got) == sorted(want)
    for name in ("data/rec_X/image0.rgb", "data/fake_X/image0.rgb",
                 "val/visual/v0"):
        assert "blobs/%s_epoch_01.jpg" % name.replace("/", "_") in got
    pm, jm = stages["pmeta"], stages["jmeta"]
    assert sorted(pm) == sorted(jm)
    assert pm["best_epoch"] == jm["best_epoch"] == 2
    assert sorted(pm["metrics"]) == sorted(jm["metrics"])
    for k, v in jm["metrics"].items():
        np.testing.assert_allclose(pm["metrics"][k], v, rtol=RTOL, err_msg=k)


def test_resume_bit_for_bit_with_the_pools(stages):
    """With 2-image pools (full after the first step, so epoch 2 draws),
    a copy of the directory after epoch 1, resumed by the train stage,
    writes epoch 2's files as the straight run does: the four networks,
    the four optimizers' moments, both pools and their generators' states,
    bit for bit."""
    root = os.path.join(stages["root"], "resume")
    cfg = copy.deepcopy(stages["cfg"])
    cfg["learning"]["checkpoints"]["directory"] = root
    cfg["learning"]["training"]["epoch_iteration"]["pool_size"] = 2
    exp = build_gan_experiment(copy.deepcopy(cfg), directory=root,
                               device="cpu")

    def hook(state, epoch):
        if epoch == 1:
            shutil.copytree(root, root + "_after1", symlinks=True)
    exp["training"].state_hook = hook
    exp["training"].run(exp["state"])
    assert exp["state"].pools["fake_X_pool"].count == 2
    cfg["learning"]["checkpoints"]["directory"] = root + "_after1"
    (meta,) = train(copy.deepcopy(cfg), (), device="cpu")
    assert meta["best_epoch"] == 2

    def load(d, name):
        return torch.load(os.path.join(d, "epochs", name), weights_only=True)
    for name in exp["models"]:
        _same(load(root, "%s_epoch_02.ckpt" % name)["model_state"],
              load(root + "_after1", "%s_epoch_02.ckpt" % name)
              ["model_state"], (name,))
    a = load(root, "training_epoch_02.pkl")
    b = load(root + "_after1", "training_epoch_02.pkl")
    assert sorted(a["aux"]["pools"]) == ["fake_X_pool", "fake_Y_pool"]
    for key in ("aux", "events", "rngs", "config", "epoch"):
        _same(a[key], b[key], (key,))


def test_pool_equals_jax_while_not_full():
    """Batches of 3 into 8-image pools: the port's answers and buffer are
    the JAX pool's exactly until it is full, whatever the draws."""
    rs = np.random.RandomState(1)
    pool = ImagePool(8, seed=4)
    jstate = jpool.init_pool(8, (5, 4, 3))
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        batch = rs.randn(3, 5, 4, 3).astype(np.float32)
        key, sub = jax.random.split(key)
        jstate, jout = jpool.pool_query(jstate, jnp.asarray(batch), sub)
        out = pool.query(torch.from_numpy(batch))
        assert np.array_equal(out.numpy(), np.asarray(jout))
        assert np.array_equal(out.numpy(), batch)
    assert pool.count == int(jstate.count) == 6
    assert np.array_equal(pool.images.numpy(), np.asarray(jstate.images))


def test_full_pool_law():
    """A full 10-image pool over 4,000 images: about half are swapped,
    and every answer is the input or an image that was stored before it;
    pool_size 0 passes the batch through."""
    pool = ImagePool(10, seed=0)
    stored = set()
    swaps = n = 0
    for i in range(2000):
        batch = torch.tensor([2.0 * i, 2.0 * i + 1]).reshape(2, 1, 1, 1)
        before = set(pool.images.flatten().tolist()) \
            if pool.images is not None and pool.count == 10 else None
        out = pool.query(batch).flatten().tolist()
        for v, x in zip(out, batch.flatten().tolist()):
            # an earlier image of the same batch may come back too
            assert v == x or v in stored
            stored.add(x)
            if before is not None:
                n += 1
                swaps += v != x
    assert pool.count == 10
    assert abs(swaps / n - 0.5) < 0.03, swaps / n
    batch = torch.ones(3, 2, 2, 3)
    assert ImagePool(0).query(batch) is batch


def test_trained_generator_loads_into_the_hub(stages):
    """generator_X_last.ckpt loads strictly into hub.cyclegan (instance
    norm, from its network_params) and serves what the trained net gives
    in eval mode."""
    path = os.path.join(stages["pdir"], "epochs", "generator_X_last.ckpt")
    model = hub.cyclegan(pretrained=True, checkpoint=path, device="cpu")
    saved = torch.load(path, weights_only=True)
    assert saved["network_params"]["model"]["norm_layer"] == "instance"
    x = np.random.RandomState(0).uniform(-1, 1, (1, 36, 44, 3)) \
        .astype(np.float32)
    from gandtr_tpu_torch.models import initialize_model
    model_cfg = dict(saved["network_params"]["model"])
    model_cfg.pop("pretrained")
    net = initialize_model(model_cfg)
    net.load_state_dict(saved["model_state"], strict=True)
    with torch.no_grad():
        want = net.eval()(torch.from_numpy(x))
    got = model(x)
    assert got.shape == (1, 36, 44, 3) and torch.equal(got, want)
