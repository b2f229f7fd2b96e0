"""The port's CUT training (models/generators.py's feature taps,
models/patchsample.py, ops/losses.py's PatchNCE, learning/gan_steps.py::
build_cut_step, scenarios/build.py's cut family) against the JAX
package's, on the CPU.

The taps are held on the 9-block layout (ngf 8, 32x32); the rest runs on
parameters/train_cut.yml cut to micro size (ngf 8 with 2 blocks, ndf 8,
32x32 crops, batch 1 as shipped, 2 epochs of 8 steps, nce_layers
4,8,12,16 as shipped: the stride-2 conv, a norm that a ReLU follows, the
first transposed conv, and a norm at which encode_only returns before its
ReLU). The two packages draw patch positions from different generators,
so the steps and the train target run on fixed positions in both
(`fixed_patch_ids`); the port's own draws are held by the resume."""
import copy
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.learning import gan_steps as jgs
from gandtr_tpu.models import initialize_model as j_model
from gandtr_tpu.ops import losses as JL
from gandtr_tpu_torch import hub
from gandtr_tpu_torch.learning import gan_steps as pgs
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.ops import losses as PL
from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.scenarios.train_stage import train
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_finetune_loop import _listing
from test_torch_gan_train import _history, _same
from torch_gan_common import (ROOT, SIDE, adam_reach,
                              seeded_variables, train_target_pair,
                              without_data)

torch.set_num_threads(1)

CUT_YML = os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs", "iccv23",
                       "train", "cut.yml")
METRICS = ("total", "D_real", "D_fake", "G_gan", "G_nce", "G_idt")
RTOL = 1e-3     # per-epoch means of the metrics and weight norms
TAP_SIZES = (256, 64, 256, 1024)    # H x W of taps 4, 8, 12, 16 at 32x32
PATCH_IDS = [np.random.RandomState(11).permutation(n)[:min(256, n)]
             for n in TAP_SIZES]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fixed_ids(mp):
    mp.setattr(jgs, "build_cut_step", functools.partial(
        jgs.build_cut_step, fixed_patch_ids=PATCH_IDS))
    mp.setitem(pgs.GAN_STEPS, "cut", functools.partial(
        pgs.build_cut_step, fixed_patch_ids=PATCH_IDS))


def _micro_cut(section):
    section["network"]["generator_X"]["model"].update(ngf=8, n_blocks=2)
    section["network"]["discriminator_Y"]["model"].update(ndf=8)
    section["data"]["train"]["loader"]["batch_size"] = 1
    # the JAX package would compile a scan of 8 steps besides the step
    # (the resume below runs the port's chunk of 8)
    section["learning"]["training"]["dispatch_chunk"] = 0
    section["sample_hw"] = SIDE     # the JAX package's init shape


def _generator(n_blocks, seed=2):
    """The JAX ResNet generator (ngf 8, instance norm) with seeded values,
    and the port's with the same weights."""
    cfg = {"architecture": "official_resnet_generator", "ngf": 8,
           "n_blocks": n_blocks, "norm_layer": "instance",
           "no_antialias": True, "no_antialias_up": True}
    jg = j_model(dict(cfg))
    x = jnp.zeros((1, SIDE, SIDE, 3))
    v = jax.tree_util.tree_map(jnp.asarray, seeded_variables(dict(
        jax.eval_shape(lambda x: jg.init(jax.random.PRNGKey(0), x), x)),
        seed))
    pg = initialize_model(dict(cfg))
    pg.load_state_dict(from_jax_variables(_host(v)), strict=True)
    return jg, v, pg


@pytest.fixture(scope="module")
def nine_blocks():
    return _generator(9)


@pytest.mark.parametrize("encode_only", [True, False])
@pytest.mark.parametrize("layers", [(4, 8, 12, 16), (4, 8)])
def test_taps_against_jax(nine_blocks, layers, encode_only):
    """The 9-block generator's taps against JAX's, each within 1e-5 of
    the tap's largest magnitude; the output too without encode_only. Tap
    8 (a norm a ReLU follows) is ReLU'd, except where encode_only returns
    at it."""
    jg, v, pg = nine_blocks
    x = np.random.RandomState(1).uniform(-1, 1, (2, SIDE, SIDE, 3)) \
        .astype(np.float32)
    jout = jg.apply(v, jnp.asarray(x), layers=layers,
                    encode_only=encode_only, train=True)
    with torch.no_grad():
        pout = pg(torch.from_numpy(x), layers=layers,
                  encode_only=encode_only)
    if not encode_only:
        (jy, jout), (py, pout) = jout, pout
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
    assert len(pout) == len(jout) == len(layers)
    for i, (a, b) in enumerate(zip(jout, pout)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert np.abs(b.numpy() - a).max() <= 1e-5 * np.abs(a).max(), i
    tap8 = pout[1].numpy()
    assert (tap8.min() < 0) == (encode_only and layers[-1] == 8)


@pytest.mark.parametrize("num_patches", [0, 16])
def test_patchsample_and_nce_against_jax(nine_blocks, num_patches):
    """PatchSampleF on the four taps with the JAX MLPs' weights and fixed
    positions: the samples, and the multilayer PatchNCE of a query and a
    key pass, within rtol 2e-3 / atol 1e-4 of JAX's; the full-map mode
    (num_patches 0) normalised over the spatial axis."""
    from gandtr_tpu.models.patchsample import PatchSampleF as JF
    jg, v, pg = nine_blocks
    rs = np.random.RandomState(3)
    xs = [rs.uniform(-1, 1, (2, SIDE, SIDE, 3)).astype(np.float32)
          for _ in range(2)]
    layers = (4, 8, 12, 16)
    jfeats = [jg.apply(v, jnp.asarray(x), layers=layers, encode_only=True)
              for x in xs]
    with torch.no_grad():
        pfeats = [pg(torch.from_numpy(x), layers=layers, encode_only=True)
                  for x in xs]
    ids = [rs.permutation(int(np.prod(f.shape[1:3])))[:num_patches]
           for f in jfeats[0]]
    jf = JF(nc=32)
    fvar = jf.init(jax.random.PRNGKey(4), jfeats[0], num_patches=num_patches,
                   rng=jax.random.PRNGKey(5))
    pf = initialize_model({"architecture": "official_p2p_mlp", "nc": 32,
                           "nce_layers": "4,8,12,16"})
    pf.create_mlp([f.shape[-1] for f in pfeats[0]])
    pf.load_state_dict(from_jax_variables(_host(fvar)), strict=True)
    assert sorted(pf.state_dict())[:2] == ["mlp_0.0.bias", "mlp_0.0.weight"]
    fixed = [jnp.asarray(i) for i in ids] if num_patches else None
    outs = []
    for jfe, pfe in zip(jfeats, pfeats):
        js, _ = jf.apply(fvar, jfe, num_patches=num_patches, patch_ids=fixed)
        with torch.no_grad():
            ps, pids = pf(pfe, num_patches=num_patches,
                          patch_ids=ids if num_patches else None)
        for a, b in zip(js, ps):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-3,
                                       atol=1e-4)
        outs.append((js, ps))
    if num_patches == 0:
        norms = (outs[0][1][0] ** 2).sum(dim=(1, 2))
        np.testing.assert_allclose(norms.numpy(), 1.0, rtol=1e-5)
        return
    assert [p.tolist() for p in pids] == [i.tolist() for i in ids]
    (jq, pq), (jk, pk) = outs
    want, _ = JL.multilayer_patch_nce_loss(jq, jk, 1, 0.07, 1.0)
    got, partial = PL.multilayer_patch_nce_loss(pq, pk, 1, 0.07, 1.0)
    assert sorted(partial) == ["layer%d" % i for i in range(4)]
    np.testing.assert_allclose(float(got), float(want), rtol=2e-3, atol=1e-4)
    want2 = JL.patch_nce_loss(jq[0], jk[0], 2, 0.2)
    got2 = PL.patch_nce_loss(pq[0], pk[0], 2, 0.2)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=2e-3,
                               atol=1e-4)


def test_patchsample_draws_and_zero_rows():
    """Drawn positions: a prefix of a permutation from the generator
    passed in (the same seed, the same positions; the global RNG not
    touched), shared by the query pass that is given them. An all-zero
    sample row gives finite gradients (_safe_norm)."""
    pf = initialize_model({"architecture": "official_p2p_mlp", "nc": 8})
    pf.create_mlp([4, 6])
    feats = [torch.randn(2, 5, 7, 4), torch.randn(2, 3, 3, 6)]
    state = torch.get_rng_state()
    a, ids = pf(feats, 16, generator=torch.Generator().manual_seed(3))
    b, ids2 = pf(feats, 16, generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.get_rng_state(), state)
    assert [len(i) for i in ids] == [16, 9]
    assert all(torch.equal(x, y) for x, y in zip(ids, ids2))
    assert sorted(ids[1].tolist()) == list(range(9))
    q, _ = pf(feats, 16, patch_ids=ids)
    assert all(torch.equal(x, y) for x, y in zip(a, q))
    with torch.no_grad():
        for m in pf.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.zero_()
    out, _ = pf([torch.zeros(1, 2, 2, 4, requires_grad=True), feats[1]], 4)
    assert float(out[0].detach().abs().max()) == 0.0
    sum(o.sum() for o in out).backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in pf.parameters())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """cut.yml's `train` target in both packages on fixed positions, then
    two steps of each from the same initial weights on seeded batches."""
    root = str(tmp_path_factory.mktemp("cut"))
    with pytest.MonkeyPatch.context() as mp:
        _fixed_ids(mp)
        out = train_target_pair(CUT_YML, root, _micro_cut)
        exp = build_gan_experiment(without_data(out["section"]),
                                   device="cpu")
    jexp = out["jexp"]
    jstate, state = jexp["state"], exp["state"]
    rs = np.random.RandomState(0)
    out["steps"] = []
    for _ in range(2):
        X, Y = (rs.uniform(-1, 1, (1, SIDE, SIDE, 3)).astype(np.float32)
                for _ in range(2))
        jstate, jm, _ = jexp["step"](jstate, jnp.asarray(X), jnp.asarray(Y))
        state, m, dbg = exp["step"](state, torch.from_numpy(X),
                                    torch.from_numpy(Y))
        out["steps"].append((
            {k: float(v) for k, v in _host(jm).items()},
            from_jax_variables(_host(jstate.variables)),
            {k: float(v) for k, v in m.items()},
            {name: {k: v.clone() for k, v in
                    net.module.state_dict().items()}
             for name, net in exp["models"].items()}, dbg))
    out["exp"] = exp
    return out


@pytest.mark.parametrize("n", [1, 2])
def test_steps_against_jax(runs, n):
    """After n steps on fixed positions: each metric within rtol 2e-3 /
    atol 2e-4 of JAX's, every parameter of the generator, featdown and D
    within 2 lr per Adam step (adam_reach: an Adam step may be up to
    1.054 lr at beta1 0.5)."""
    jm, jv, pm, pv, dbg = runs["steps"][n - 1]
    assert sorted(pm) == sorted(jm) == sorted(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(pm[k], jm[k], rtol=2e-3, atol=2e-4,
                                   err_msg=k)
    for name in ("generator_X", "featdown", "discriminator_Y"):
        opt = runs["exp"]["optimizers"][name]
        (group,) = opt.param_groups
        bound = 2 * group["lr"] * adam_reach(n, group["betas"][0])
        assert sorted(pv[name]) == sorted(jv[name])
        for key, want in jv[name].items():
            diff = float((pv[name][key] - want).abs().max())
            assert diff <= bound, (name, key, diff, bound)
    assert dbg["idt_Y"].shape == dbg["fake_Y"].shape == (SIDE, SIDE, 3)


def test_train_target_against_jax(runs):
    """cut.yml's `train` target: the same
    event keys each epoch, each per-epoch mean within RTOL of JAX's, the
    same checkpoint and blob files (featdown's among them, idt_Y's
    sample), the same stage metadata keys and best epoch."""
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
    for name in ("featdown_epoch_02.ckpt", "featdown_last.ckpt",
                 "blobs/data_idt_Y_image0.rgb_epoch_01.jpg",
                 "blobs/val_visual_v0_epoch_02.jpg"):
        assert name in got, name
    (_, jmeta), (_, pmeta) = (list(r.items()) for r in (runs["jax"],
                                                         runs["port"]))
    jmeta, pmeta = jmeta[1], pmeta[1]
    assert sorted(pmeta) == sorted(jmeta)
    assert pmeta["best_epoch"] == jmeta["best_epoch"] == 2
    assert sorted(pmeta["metrics"]) == sorted(jmeta["metrics"])


def test_resume_bit_for_bit(runs):
    """With drawn positions and dispatch_chunk 8 as shipped: a copy of the
    directory after epoch 1,
    resumed by the train stage, writes epoch 2's files as the straight
    run does, the three networks, the three optimizers' moments and the
    patch generator's state bit for bit; the straight run drew other
    positions each step."""
    root = os.path.join(os.path.dirname(runs["pdir"]), "resume")
    cfg = copy.deepcopy(runs["section"])
    cfg["learning"]["checkpoints"]["directory"] = root
    cfg["learning"]["training"]["dispatch_chunk"] = 8   # as shipped
    exp = build_gan_experiment(copy.deepcopy(cfg), directory=root,
                               device="cpu")
    start = exp["state"].rngs["patches"].get_state()

    def hook(state, epoch):
        if epoch == 1:
            shutil.copytree(root, root + "_after1", symlinks=True)
    exp["training"].state_hook = hook
    exp["training"].run(exp["state"])
    assert not torch.equal(exp["state"].rngs["patches"].get_state(), start)
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
    assert sorted(a["aux"]["rngs"]) == ["patches"]
    for key in ("aux", "events", "rngs", "config", "epoch"):
        _same(a[key], b[key], (key,))


def test_trained_generator_loads_into_the_hub(runs):
    """The CUT-trained generator_X_last.ckpt (instance norm, 2 blocks)
    loads strictly into hub.cyclegan, and serves in bf16 what the net
    gives with its blocks through K3's plain version here."""
    path = os.path.join(runs["pdir"], "epochs", "generator_X_last.ckpt")
    model = hub.cyclegan(pretrained=True, checkpoint=path, device="cpu")
    saved = torch.load(path, weights_only=True)
    assert saved["network_params"]["model"]["norm_layer"] == "instance"
    x = np.random.RandomState(0).uniform(-1, 1, (1, 36, 44, 3)) \
        .astype(np.float32)
    model_cfg = dict(saved["network_params"]["model"])
    model_cfg.pop("pretrained")
    net = initialize_model(model_cfg)
    net.load_state_dict(saved["model_state"], strict=True)
    with torch.no_grad():
        want = net.eval()(torch.from_numpy(x))
    assert torch.equal(model(x), want)
    model.net.compute_dtype = torch.bfloat16
    got = model(x).float()
    assert got.shape == (1, 36, 44, 3)
    assert float((got - want).abs().max()) < 0.1


def test_encoder_passes_keep_batch_statistics(runs):
    """With a batch-norm generator (no published CUT config has one) the
    PatchNCE encoder passes leave its running statistics as they were,
    as the JAX step discards them: one step moves them once, as one
    forward of the batch does."""
    cfg = without_data(runs["section"])
    cfg["network"]["generator_X"]["model"]["norm_layer"] = "batch"
    for name in ("generator_X", "featdown", "discriminator_Y"):
        cfg["network"][name]["model"].pop("pretrained", None)
    exp = build_gan_experiment(cfg, device="cpu")
    G = exp["models"]["generator_X"].module
    ref = {k: v.clone() for k, v in G.state_dict().items()}
    rs = np.random.RandomState(4)
    X, Y = (torch.from_numpy(rs.uniform(-1, 1, (1, SIDE, SIDE, 3))
                             .astype(np.float32)) for _ in range(2))
    exp["step"](exp["state"], X, Y)
    bns = [m for m in G.modules() if hasattr(m, "num_batches_tracked")]
    assert bns and all(int(m.num_batches_tracked) == 1 for m in bns)
    G.load_state_dict(ref)
    with torch.no_grad():
        G.train()(torch.cat([X, Y]))
    for k, v in G.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, exp["models"]["generator_X"].module
                               .state_dict()[k]), k
