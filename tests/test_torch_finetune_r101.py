"""Step 1 of `finetune_r101` (finetune.yml with a ResNet embed and margin
0.85) in the port: one float32 tuple step against the JAX step, and the
chain the target runs on the CPU: the fine-tune loop through
`build_finetune_experiment`, its `epochs/embed_best.ckpt`, step 2
(`infer_and_learn_whitening`) and step 4 (`validate`) from that file.

The embed is tests/test_torch_resnet.py's reduced-depth ResNet (RESNET_T,
blocks (1, 1, 2, 1), 2048-d), the augment net a batch-norm generator of
ngf 4 and one block behind the published wrapper chain
(tests/test_torch_finetune.py's). The JAX variables take the port's seeded
weights through the JAX importer (initialised by shape: a JAX init
compiles for a long time).

Tolerances: the descriptors of a tuple and the loss within 1e-4, each
parameter's gradient within 1e-4 of its norm (float32 sums of about 20
layers in other orders; the VGG16 step is held at 1e-5 and 5e-5)."""
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from gandtr_tpu.learning import supervised as jsup
from gandtr_tpu.learning.network import build_single_net as j_build
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.learning import supervised
from gandtr_tpu_torch.learning.criteria import initialize_criterion
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.learning.optimizers import initialize_optimizer
from gandtr_tpu_torch.models.init import initialize_weights
from gandtr_tpu_torch.models.layers import FrozenBatchNorm
from gandtr_tpu_torch.scenarios import finetune_build
from gandtr_tpu_torch.scenarios import multistep_stage as tmultistep
from gandtr_tpu_torch.scenarios import validate_stage as tvalidate
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_eval_r101 import eval_params, write_eval_set
from test_torch_finetune import (WRAPPERS, _grab_grads, _jax_augment,
                                 _port_descriptors, _torch)
from test_torch_finetune_loop import _synth, micro_params
from test_torch_resnet import (MODEL, RESNET_T, TOL, reduced_resnet,
                               seeded_net)
from test_torch_whitening import whitening_params, write_whiten_set

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
__all__ = ["reduced_resnet"]    # the module-scoped RESNET_T fixture

T, S, B = 2, 3, 64
RECTS = [(60, 52), (52, 60), (64, 47)]
ADAM = {"algorithm": "adam", "lr": 5e-7, "beta1": 0.9, "beta2": 0.999,
        "weight_decay": 0.0005}
MARGIN = 0.85                   # _train.yml:61, finetune_r101


def _step_configs():
    augment = {"model": {"architecture": "official_resnet_generator",
                         "ngf": 4, "n_blocks": 1, "norm_layer": "batch",
                         "no_antialias": True, "no_antialias_up": True},
               "runtime": {"frozen": True, "wrappers": WRAPPERS, "data": {}}}
    embed = {"model": dict(MODEL, cir_architecture=RESNET_T),
             "runtime": {"wrappers": "", "data": {}}}
    return augment, embed


def _step_batch(seed=0):
    rng = np.random.RandomState(seed)
    imgs = np.zeros((T, S, B, B, 3), np.float32)
    masks = np.zeros((T, S, B, B), np.float32)
    for t in range(T):
        for s, (h, w) in enumerate(RECTS):
            imgs[t, s, :h, :w] = rng.uniform(-1, 1, (h, w, 3))
            masks[t, s, :h, :w] = 1.0
    labels = np.asarray([[-1, 1, 0]] * T, np.float32)
    pmask = np.zeros((T, S), bool)
    pmask[0, 0] = True
    return imgs, masks, labels, pmask


def test_f32_finetune_r101_step_matches_jax():
    """The reduced-depth ResNet embed behind the published augment chain
    (a batch-norm generator of ngf 4 and one block), margin 0.85, float32:
    the descriptors of tuple 0 and the loss within 1e-4, each parameter's
    gradient within 1e-4 of its norm. The port's step leaves every
    BatchNorm statistic bit-equal and gives the BN affine gradients."""
    acfg, ecfg = _step_configs()
    models = {"augment": build_single_net(acfg),
              "embed": build_single_net(ecfg)}
    initialize_weights(models["augment"].module, "kaiming_p2p", 0)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, buf in models["augment"].module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    models["embed"].module.load_state_dict(
        seeded_net(ecfg["model"], seed=1).state_dict())
    models["augment"].module.eval().requires_grad_(False)
    jmodels = {"augment": j_build(acfg), "embed": j_build(ecfg)}
    x0 = jnp.zeros((S, B, B, 3), jnp.float32)
    variables = {}
    for (name, m), arch in zip(models.items(), ("", "cirnet")):
        shapes = jax.eval_shape(functools.partial(
            jmodels[name].module.init, **({"train": False} if name ==
                                          "augment" else {})),
            jax.random.PRNGKey(0), x0)
        template = jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), shapes)
        variables[name] = jax.tree_util.tree_map(
            jnp.asarray, ti.convert_torch_state(
                template,
                {k: v.numpy() for k, v in m.module.state_dict().items()},
                key_map=ti.key_map_for_architecture(arch), min_coverage=1.0))

    imgs, masks, labels, pmask = _step_batch()
    ax, am = _jax_augment(jmodels, variables, imgs, masks, pmask)
    want = np.asarray(jax.jit(lambda v, x, m: jmodels["embed"].apply(
        v, x, train=True, mask=m))(variables["embed"], jnp.asarray(ax[0]),
                                   jnp.asarray(am[0])))
    got = _port_descriptors(models, *_torch(imgs[0], masks[0], pmask[0]))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)

    tx = _grab_grads()
    jstep = jax.jit(jsup.build_finetune_step({"embed": jmodels["embed"]}, tx,
                                             margin=MARGIN))
    jstate, jm = jstep(jsup.make_finetune_state(variables, tx),
                       jnp.asarray(ax), jnp.asarray(am), jnp.asarray(labels),
                       jnp.asarray(pmask))
    stats = {k: v.clone() for k, v in
             models["embed"].module.named_buffers()}
    net = models["embed"].module
    opt, _ = initialize_optimizer(dict(ADAM), net.named_parameters(),
                                  "cirnet")
    step = supervised.build_finetune_step(
        models, opt, initialize_criterion({"loss": "contrastive",
                                           "margin": MARGIN}),
        augment_positions=(0,))
    _, m = step(supervised.make_finetune_state(models, opt),
                *_torch(imgs, masks, labels, pmask))
    np.testing.assert_allclose(float(m["total"]), float(jm["total"]),
                               rtol=TOL)
    jgrads = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.opt_state}))
    assert sorted(jgrads) == sorted(k for k, _ in net.named_parameters())
    for k, p in net.named_parameters():
        gp, gw = p.grad.numpy(), jgrads[k].numpy()
        assert np.linalg.norm(gp - gw) <= TOL * np.linalg.norm(gw), k
    for k, v in net.named_buffers():
        assert torch.equal(v, stats[k]), k
    assert float(net.features[4][0].bn1.weight.grad.abs().sum()) > 0


# ---- the chain of finetune_r101 on the CPU, in the port

def r101_params(epochs=1):
    """The micro fine-tune of tests/test_torch_finetune_loop.py with the
    target's overrides: the ResNet embed and margin 0.85."""
    params = micro_params()
    params["network"]["embed"]["model"]["cir_architecture"] = RESNET_T
    params["learning"]["training"]["criterion"]["margin"] = MARGIN
    params["learning"]["training"]["epochs"] = epochs
    return params


@pytest.fixture(scope="module")
def chain(tmp_path_factory, reduced_resnet):
    root = tmp_path_factory.mktemp("finetune_r101")
    db, images = _synth(root)
    directory = str(root / "exp")
    exp = finetune_build.build_finetune_experiment(
        r101_params(), directory, db, images, device="cpu")
    embed = exp["models"]["embed"].module
    first = {k: v.detach().clone() for k, v in embed.named_parameters()}
    buffers = {k: v.clone() for k, v in embed.named_buffers()}
    losses = []
    step = exp["training"].loop.step_fn

    def counted(state, *args):
        state, m = step(state, *args)
        losses.append(float(m["total"]))
        return state, m

    exp["training"].loop.step_fn = counted
    state = exp["training"].run(exp["state"])
    ckpt = os.path.join(directory, "epochs", "embed_best.ckpt")
    whiten_pkl = write_whiten_set(str(root))
    (wmeta,) = tmultistep.infer_and_learn_whitening(
        whitening_params(ckpt, whiten_pkl, str(root / "ims"), directory),
        None, device="cpu")
    write_eval_set(str(root))
    (res,), rec = chip_smoke._recorded(tvalidate, lambda: tvalidate.validate(
        eval_params(ckpt, wmeta["whitening_path"], str(root)), None,
        device="cpu"))
    return {"exp": exp, "state": state, "first": first, "buffers": buffers,
            "losses": losses, "ckpt": ckpt, "directory": directory,
            "whitening": wmeta, "validate": (res, rec[0])}


def test_loop_trains_the_resnet_embed(chain):
    """Finite losses; every embed parameter moved, the BN affine included;
    every BatchNorm statistic bit-equal; the optimizer's groups are the
    cirnet table (GeM p x10)."""
    assert len(chain["losses"]) == len(chain["exp"]["loader"]) > 0
    assert np.all(np.isfinite(chain["losses"]))
    embed = chain["state"].models["embed"].module
    for k, p in embed.named_parameters():
        assert not torch.equal(p.detach(), chain["first"][k]), k
    for k, v in embed.named_buffers():
        assert torch.equal(v, chain["buffers"][k]), k
    assert any(isinstance(m, FrozenBatchNorm) for m in embed.modules())
    assert sorted(g["lr_mult"] for g in
                  chain["state"].optimizer.param_groups) == [1.0, 10.0]


def test_embed_best_ckpt_holds_the_trained_net(chain):
    saved = torch.load(chain["ckpt"], map_location="cpu", weights_only=True)
    assert saved["network_params"]["model"]["cir_architecture"] == RESNET_T
    trained = chain["state"].models["embed"].module.state_dict()
    assert sorted(saved["model_state"]) == sorted(trained)
    for k, v in trained.items():
        assert torch.equal(saved["model_state"][k], v), k


def test_whitening_from_the_ckpt(chain):
    """Step 2 from `embed_best.ckpt`: the pickle at the target's path, a
    2048x2048 P, learned from the trained net's descriptors."""
    path = chain["whitening"]["whitening_path"]
    assert path == os.path.join(chain["directory"], "whitening",
                                "lw-retrieval.pkl")
    with open(path, "rb") as f:
        lw = pickle.load(f)
    assert lw["P"].shape == (2048, 2048) and np.isfinite(lw["P"]).all()


def test_validate_from_the_ckpt(chain):
    """Step 4 from `embed_best.ckpt` and step 2's pickle: 2048-d unit-norm
    descriptors, the protocol's mAPs."""
    res, (metrics, _, vecs, qvecs) = chain["validate"]
    assert vecs.shape[0] == qvecs.shape[0] == 2048
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=0), 1.0,
                               atol=1e-5)
    meta = res["metadata"]["validation"]
    assert meta["config:data.shape_bucket"] == 64
    assert sorted(metrics) == ["map_easy", "map_hard", "map_medium"]
    assert all(0 <= v <= 1 for v in metrics.values())


def test_chip_smoke_r101_config_is_the_target_s():
    """chip_smoke's finetune_r101 loop is its finetune.yml loop with the
    overrides of _train.yml's finetune_r101 step 1 (the checkpoint
    directory aside) and its own epochs; its step 2 and step 4 sections
    are whitening.yml and eval.yml with that target's overrides."""
    with open(os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs",
                           "iccv23", "train", "_train.yml")) as f:
        target = yaml.safe_load(f)["finetune_r101"]
    cfg = chip_smoke.finetune_r101_config("db.pkl", "ims")
    want = chip_smoke.finetune_loop_config("db.pkl", "ims")
    want["learning"]["training"]["epochs"] = chip_smoke.R101_EPOCHS
    for key, value in target["1_finetune_embed"].items():
        if key.startswith("__") or key == "learning.checkpoints.directory":
            continue
        node = want
        *head, last = key.split(".")
        for k in head:
            node = node[k]
        node[last] = value
    assert cfg == want
    assert cfg["network"]["embed"]["model"]["cir_architecture"] == \
        "resnet101"
    params = chip_smoke.r101_whitening_params("ckpt", "pkl", "ims", "dir")
    assert params["network"]["model"]["cir_architecture"] == "resnet101"
    assert params["output"]["dimensions"] == \
        target["2_train_whitening"]["output.dimensions"]
    with open(os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs",
                           "iccv23", "parameters", "whitening.yml")) as f:
        shipped = yaml.safe_load(f)
    for section in ("network", "data"):
        for k, v in shipped[section].items():
            if k in ("path", "model", "image_dir"):
                continue
            assert params[section][k] == v, (section, k)
    assert params["network"]["model"] == dict(
        shipped["network"]["model"], cir_architecture="resnet101")
