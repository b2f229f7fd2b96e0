"""The port's HED^N-GAN train stage (scenarios/train_stage.py::train on
scenarios/build.py, with learning/{gan_steps,training,events,
html_report,checkpoints}.py and the GAN data) against the JAX package's
`train_stage.train`, on the CPU, on train_hedngan.yml cut to micro size
(tests/torch_gan_common.py: 2 epochs of 4 steps on 32x32 crops, the decay
in epoch 2, checkpoint_every 1, store_every 2, visual validation every
epoch). The JAX nets start from seeded values over their shapes; those
initial variables go to the port as local `pretrained:` files through
`from_jax_variables`. Both stages run once (`stages`); the port also
resumes, hands its generator to the hub and to the fine-tune, and runs
chunked."""
import copy
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import gandtr_tpu.scenarios.build as jbuild
from gandtr_tpu.scenarios.train_stage import train as j_train
from gandtr_tpu_torch import hub
from gandtr_tpu_torch.scenarios import finetune_build
from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.scenarios.train_stage import train
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_finetune_loop import _listing, _synth, micro_params
from torch_gan_common import micro_config, shape_init

torch.set_num_threads(1)

RTOL = 1e-3     # per-epoch means of the metrics and weight norms


def _with_initial_weights(cfg, root, variables):
    """cfg with each member's `pretrained:` a local file of `variables`."""
    cfg = copy.deepcopy(cfg)
    for name, sd in from_jax_variables(
            jax.tree_util.tree_map(np.asarray, variables)).items():
        path = os.path.join(root, "init_%s.pth" % name)
        torch.save(sd, path)
        cfg["network"][name]["model"]["pretrained"] = path
    return cfg


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gan_train"))
    cfg = micro_config(root)
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        orig = jbuild.build_gan_experiment

        def recording(*args, **kwargs):
            exp = orig(*args, **kwargs)
            captured["variables"] = exp["variables"]
            return exp
        mp.setattr(jbuild, "build_gan_experiment", recording)
        (jmeta,) = j_train(copy.deepcopy(cfg), ())
    pcfg = _with_initial_weights(cfg, root, captured["variables"])
    pcfg["learning"]["checkpoints"]["directory"] = os.path.join(root, "port")
    (pmeta,) = train(copy.deepcopy(pcfg), (), device="cpu")
    return {"root": root, "cfg": pcfg, "jmeta": jmeta, "pmeta": pmeta,
            "jdir": cfg["learning"]["checkpoints"]["directory"],
            "pdir": pcfg["learning"]["checkpoints"]["directory"]}


def _history(directory):
    import json
    with open(os.path.join(directory, "epochs", "events.json")) as f:
        return json.load(f)


def test_events_against_jax(stages):
    """The same event keys each epoch, each per-epoch mean within RTOL of
    JAX's; the last epoch's metrics and the best epoch as stage
    metadata."""
    jh, ph = _history(stages["jdir"]), _history(stages["pdir"])
    assert [e["epoch"] for e in ph] == [e["epoch"] for e in jh] == [1, 2]
    for je, pe in zip(jh, ph):
        assert sorted(pe["metrics"]) == sorted(je["metrics"])
        for k, v in je["metrics"].items():
            np.testing.assert_allclose(pe["metrics"][k], v, rtol=RTOL,
                                       err_msg=k)
    for k in ("D_real", "D_fake", "G_gan", "G_hed", "E_real", "E_fake",
              "total"):
        assert "train/learning/" + k in ph[0]["metrics"]
    pm, jm = stages["pmeta"], stages["jmeta"]
    assert pm["best_epoch"] == jm["best_epoch"] == 2
    # the flat last-epoch values, and the reference's per-epoch key forms
    # as the JAX stage gives them
    flat = {k: v for k, v in pm["metrics"].items() if k in ph[-1]["metrics"]}
    assert flat == ph[-1]["metrics"]
    assert sorted(pm["metrics"]) == sorted(jm["metrics"])
    for k, v in jm["metrics"].items():
        np.testing.assert_allclose(pm["metrics"][k], v, rtol=RTOL,
                                   err_msg=k)
    assert sorted(pm) == sorted(jm)
    assert all(np.isfinite(v) for e in ph for v in e["metrics"].values())


def test_files_against_jax(stages):
    """The same checkpoint file names and symlinks, the same blob names
    (traindata samples of epoch 1, weight histograms, the visual
    validation of both epochs) and an HTML report."""
    got, want = _listing(stages["pdir"]), _listing(stages["jdir"])
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if v} == \
        {k: v for k, v in want.items() if v}
    for name in ("data/real_X/image0.rgb", "data/real_E/image0.chan1",
                 "data/real_E_check/image0.chan1", "val/visual/v0"):
        assert "blobs/%s_epoch_01.jpg" % name.replace("/", "_") in got
    assert "blobs/val_visual_v3_epoch_02.jpg" in got
    report = os.path.join(stages["pdir"], "epochs", "htmlreport",
                          "index.html")
    text = open(report).read()
    assert "epoch 2" in text and "val_visual_v0_epoch_02.jpg" in text
    assert "train/learning/G_hed" in text and "Distributions" in text


def _snapshot(state):
    return ({name: {k: v.clone() for k, v in net.module.state_dict().items()}
             for name, net in state.models.items()},
            {name: opt.state_dict() for name, opt in
             state.optimizers.items()})


def _same(a, b, where=()):
    """Nested dicts, lists and tensors equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], where + (k,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, where + (i,))
    else:
        assert a == b, where


def test_resume_bit_for_bit(stages):
    """A copy of the directory as it was after epoch 1, resumed by the
    train stage, writes epoch 2's files as the straight run does: every
    network (weights and BatchNorm statistics), the Adam moments of all
    three optimizers, the step and the events, bit for bit. The loader's
    shuffle state is in the training file."""
    root = os.path.join(stages["root"], "resume")
    cfg = copy.deepcopy(stages["cfg"])
    cfg["learning"]["checkpoints"]["directory"] = root
    exp = build_gan_experiment(copy.deepcopy(cfg), directory=root,
                               device="cpu")

    def hook(state, epoch):
        if epoch == 1:
            shutil.copytree(root, root + "_after1", symlinks=True)
    exp["training"].state_hook = hook
    exp["training"].run(exp["state"])
    cfg["learning"]["checkpoints"]["directory"] = root + "_after1"
    probe = build_gan_experiment(copy.deepcopy(cfg),
                                 directory=root + "_after1", device="cpu")
    state, start = probe["training"].resume_or_start(probe["state"])
    assert start == 2 and state.step == 4
    (meta,) = train(copy.deepcopy(cfg), (), device="cpu")
    assert meta["best_epoch"] == 2
    for d in (root, root + "_after1"):
        assert os.path.exists(os.path.join(d, "epochs",
                                           "training_epoch_02.pkl"))

    def load(d, name):
        return torch.load(os.path.join(d, "epochs", name), weights_only=True)
    for name in exp["models"]:
        _same(load(root, "%s_epoch_02.ckpt" % name)["model_state"],
              load(root + "_after1", "%s_epoch_02.ckpt" % name)
              ["model_state"], (name,))
    a = load(root, "training_epoch_02.pkl")
    b = load(root + "_after1", "training_epoch_02.pkl")
    for key in ("aux", "events", "rngs", "config", "epoch"):
        _same(a[key], b[key], (key,))


def test_dispatch_chunk_gives_the_same_run(stages):
    """dispatch_chunk 2 against 1 (a read-back each step): the same
    networks and moments bit for bit."""
    runs = []
    for chunk in (1, 2):
        cfg = copy.deepcopy(stages["cfg"])
        cfg["learning"]["training"]["dispatch_chunk"] = chunk
        exp = build_gan_experiment(cfg, device="cpu")
        runs.append(_snapshot(exp["training"].run(exp["state"])))
    _same(*runs)


def test_trained_generator_loads_into_the_hub(stages):
    """generator_X_last.ckpt loads strictly into hub.hedngan (batch norm,
    from its network_params) and serves what the trained net gives in
    eval mode."""
    path = os.path.join(stages["pdir"], "epochs", "generator_X_last.ckpt")
    model = hub.hedngan(pretrained=True, checkpoint=path, device="cpu")
    saved = torch.load(path, weights_only=True)
    assert saved["network_params"]["model"]["norm_layer"] == "batch"
    x = np.random.RandomState(0).uniform(-1, 1, (1, 36, 44, 3)) \
        .astype(np.float32)
    from gandtr_tpu_torch.models import initialize_model
    model_cfg = dict(saved["network_params"]["model"])
    model_cfg.pop("pretrained")     # the test's initial weights
    net = initialize_model(model_cfg)
    net.load_state_dict(saved["model_state"], strict=True)
    with torch.no_grad():
        want = net.eval()(torch.from_numpy(x))
    got = model(x)
    assert got.shape == (1, 36, 44, 3) and torch.equal(got, want)


def test_trained_generator_is_the_finetune_augment(stages, tmp_path):
    """The `all` target's hand-off: generator_X_best.ckpt as
    network.augment.path of the port's fine-tune build loads strictly into
    its batch-norm augment net."""
    db, images = _synth(tmp_path)
    params = micro_params()
    path = os.path.join(stages["pdir"], "epochs", "generator_X_best.ckpt")
    params["network"]["augment"]["path"] = path
    exp = finetune_build.build_finetune_experiment(
        params, db=db, images=images, device="cpu")
    want = torch.load(path, weights_only=True)["model_state"]
    got = exp["models"]["augment"].module.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_zero_epochs_and_other_networks(tmp_path):
    """`epochs: 0` writes the untrained networks as <name>_notrain.ckpt
    and trains nothing; an unknown network type raises."""
    cfg = micro_config(str(tmp_path))
    cfg["learning"]["training"]["epochs"] = 0
    assert train(copy.deepcopy(cfg), (), device="cpu") == ({},)
    files = os.listdir(os.path.join(cfg["learning"]["checkpoints"]
                                    ["directory"], "epochs"))
    for name in ("generator_X", "discriminator_Y", "detector",
                 "detector_frozen"):
        assert "%s_notrain.ckpt" % name in files
    cfg["network"]["type"] = "MultiheadNetwork"
    with pytest.raises(NotImplementedError, match="MultiheadNetwork"):
        train(cfg, (), device="cpu")


def test_chip_smoke_gan_config_is_train_hedngan():
    """The chip smoke's GAN phase runs train_hedngan.yml as shipped (its
    validation template expanded), cut only by GAN_CUTS."""
    import chip_smoke
    from gandtr_tpu.scenarios.engine import load_yaml_scenario
    from torch_gan_common import TRAIN_HEDNGAN
    assert chip_smoke.GAN_TRAIN == load_yaml_scenario([TRAIN_HEDNGAN])
    cfg = chip_smoke.gan_train_config("/r", ["/r/day.txt", "/r/night.txt"])
    lt = cfg["learning"]["training"]
    assert lt["epochs"] == 2 and lt["dispatch_chunk"] == 8
    assert {s["n_epochs_decay"] for s in lt["scheduler"].values()} == {1}
    assert cfg["data"]["train"]["dataset"]["size"] == 40
    assert cfg["data"]["train"]["loader"] == {"batch_size": 10}
    assert cfg["network"]["generator_X"] == \
        chip_smoke.GAN_TRAIN["network"]["generator_X"]
