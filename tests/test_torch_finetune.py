"""The port's GeM fine-tune tuple step (gandtr_tpu_torch/learning/
supervised.py, scenarios/finetune_build.py) and its masked padded-bucket
chain against the JAX package, on the CPU, on the same weights (carried
across with utils/weights.from_jax_variables) and the same seeded inputs.

The template of tests/test_finetune_step.py: a generator of ngf 4 and one
block (batch and instance norm) in the augment net with the published
wrapper chain, the full-width GeM-VGG16, a 32 bucket with 30x26 and 26x30
images, T = 2 tuples of S = 3."""
import copy
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gandtr_tpu.learning import supervised as jsup
from gandtr_tpu.learning import wrappers as jwrappers
from gandtr_tpu.learning.network import build_single_net as j_build
from gandtr_tpu.learning.optimizers import (initialize_optimizer as j_opt,
                                            param_group_mults)
from gandtr_tpu.models.init import initialize_weights as j_init_weights
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.data.cir_datasets import generator_safe_bucket
from gandtr_tpu_torch.learning import supervised
from gandtr_tpu_torch.learning import wrappers
from gandtr_tpu_torch.learning.criteria import initialize_criterion
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.learning.optimizers import initialize_optimizer
from gandtr_tpu_torch.ops import pooling
from gandtr_tpu_torch.scenarios import finetune_build
from gandtr_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

MEANSTD_GEN = "[[0.5,0.5,0.5],[0.5,0.5,0.5]]"
MEANSTD_IMNET = "[[0.485,0.456,0.406],[0.229,0.224,0.225]]"
WRAPPERS = (f"meanstd_post:{MEANSTD_GEN}:{MEANSTD_IMNET},"
            f"clahepost:{MEANSTD_GEN}:1.0,cir_ratio_pass_through:0.25:anc")
T, S, B = 2, 3, 32
RECTS = [(30, 26), (26, 30), (30, 26)]
ADAM = {"algorithm": "adam", "lr": 1e-3, "beta1": 0.9, "beta2": 0.999,
        "weight_decay": 0.0005}


def _configs(norm, dtype=None):
    augment = {"model": {"architecture": "official_resnet_generator",
                         "ngf": 4, "n_blocks": 1, "norm_layer": norm,
                         "no_antialias": True, "no_antialias_up": True},
               "runtime": {"frozen": True, "wrappers": WRAPPERS, "data": {}}}
    embed = {"model": {"architecture": "cirnet", "cir_architecture": "vgg16",
                       "pooling": "gem", "local_whitening": False,
                       "whitening": False},
             "runtime": {"wrappers": "", "data": {}, "dtype": dtype}}
    return augment, embed


def _jax_variables(jmodels, norm, seed=0):
    """JAX init, kaiming_p2p generator weights and, for batch norm,
    non-trivial running statistics."""
    # jitted: the eager inits compile op by op (tens of seconds)
    x0 = jnp.zeros((S, B, B, 3), jnp.float32)
    va = dict(jax.jit(lambda k, x: jmodels["augment"].init(k, x, train=False))(
        jax.random.PRNGKey(seed), x0))
    va["params"] = jax.jit(lambda p, k: j_init_weights(
        p, k, weights="kaiming_p2p"))(va["params"], jax.random.PRNGKey(seed))
    if norm == "batch":
        rng = np.random.RandomState(seed + 3)
        va["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(
                rng.randn(*a.shape) * 0.1 if p[-1].key == "mean"
                else rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            va["batch_stats"])
    ve = dict(jax.jit(jmodels["embed"].init)(jax.random.PRNGKey(seed + 1),
                                             x0))
    return {"augment": va, "embed": ve}


@functools.lru_cache(maxsize=None)
def _jax_pair(norm, dtype=None):
    """The JAX models and variables, made once per configuration (JAX
    arrays are immutable; the tests change only the port's modules)."""
    acfg, ecfg = _configs(norm, dtype)
    jmodels = {"augment": j_build(acfg), "embed": j_build(ecfg)}
    return jmodels, _jax_variables(jmodels, norm)


def _pair(norm, dtype=None):
    """(JAX models, JAX variables, fresh port models) on the same
    weights."""
    acfg, ecfg = _configs(norm, dtype)
    jmodels, variables = _jax_pair(norm, dtype)
    sd = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    models = {"augment": build_single_net(acfg),
              "embed": build_single_net(ecfg)}
    for name, m in models.items():
        m.module.load_state_dict(sd[name], strict=True)
    models["augment"].module.eval().requires_grad_(False)
    return jmodels, variables, models


def _batch(seed=0):
    """Generator-normalized tuples with a zero band, masks, labels, and the
    anchor of tuple 0 passed through the generator."""
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


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port_descriptors(models, imgs, masks, pmask):
    with torch.no_grad():
        x, m = models["augment"].apply(imgs, ctx={"pass_mask": pmask},
                                       train=True, model_positions=(0,),
                                       mask=masks)
        return models["embed"].apply(x, train=True, mask=m).float().numpy()


def _jax_augment(jmodels, variables, imgs, masks, pmask):
    """The JAX augment chain on one tuple (S, ...) or on (T, S, ...) tuples,
    run eagerly as the JAX package's CLAHE tests run it: XLA's CPU jit
    contracts multiply-adds into FMAs, which on most inputs moves a uint8
    CLAHE level of the chain away from cv2 (and so from the port, which
    equals cv2, tests/test_torch_clahe_masked.py); op by op nothing is
    contracted. Returns the augmented images and their valid masks."""
    if imgs.ndim == 4:
        x, m = _jax_augment(jmodels, variables, imgs[None], masks[None],
                            pmask[None])
        return x[0], m[0]
    xs, ms = [], []
    with jax.disable_jit():
        for t in range(imgs.shape[0]):
            x, m = jmodels["augment"].apply(
                variables["augment"], jnp.asarray(imgs[t]), train=True,
                ctx={"pass_mask": jnp.asarray(pmask[t])},
                model_positions=(0,), mask=jnp.asarray(masks[t]))
            xs.append(np.asarray(x))
            ms.append(np.asarray(m))
    return np.stack(xs), np.stack(ms)


def _jax_descriptors(jmodels, variables, imgs, masks, pmask):
    x, m = _jax_augment(jmodels, variables, imgs, masks, pmask)
    fwd = jax.jit(lambda v, x, m: jmodels["embed"].apply(v, x, train=True,
                                                         mask=m))
    return np.asarray(fwd(variables["embed"], x, m), np.float32)


def _grab_grads():
    """An optax transformation that keeps the step's gradients as its state
    and leaves the parameters where they are."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _criterion():
    return initialize_criterion({"loss": "contrastive", "margin": 0.75})


def _steps(jmodels, variables, models, fakebatch=True, seed=0, tx=None):
    """One step of each on the same batch: (JAX loss, JAX new state, port
    loss, port embed module). The JAX step takes the eagerly augmented
    batch (`_jax_augment`) and `tx` (default the published Adam); the port
    step runs its whole chain, with the published Adam."""
    imgs, masks, labels, pmask = _batch(seed)
    if tx is None:
        mults = param_group_mults("cirnet", variables["embed"]["params"])
        tx, _ = j_opt(dict(ADAM), group_mults=mults)
    ax, am = _jax_augment(jmodels, variables, imgs, masks, pmask)
    jstep = jax.jit(jsup.build_finetune_step({"embed": jmodels["embed"]}, tx,
                                             margin=0.75,
                                             fakebatch=fakebatch))
    jstate, jm = jstep(jsup.make_finetune_state(variables, tx),
                       jnp.asarray(ax), jnp.asarray(am),
                       jnp.asarray(labels), jnp.asarray(pmask))
    opt, _ = initialize_optimizer(dict(ADAM),
                                  models["embed"].module.named_parameters(),
                                  "cirnet")
    step = supervised.build_finetune_step(models, opt, _criterion(),
                                          fakebatch=fakebatch,
                                          augment_positions=(0,))
    state = supervised.make_finetune_state(models, opt)
    _, m = step(state, *_torch(imgs, masks, labels, pmask))
    return float(jm["total"]), jstate, float(m["total"]), models["embed"].module


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_masked_generator_matches_jax(norm):
    """The masked generator (masked reflect pad, masked instance norm or a
    frozen BatchNorm re-zeroed) against the JAX package's: the output and
    its valid mask, float32, 1e-5."""
    jmodels, variables, models = _pair(norm)
    imgs, masks, _, _ = _batch(seed=1)
    x, m = imgs[0], masks[0]
    want, wmask = jax.jit(lambda v, x, m: jmodels["augment"].module.apply(
        v, x, train=False, mask=m))(variables["augment"], jnp.asarray(x),
                                    jnp.asarray(m))
    with torch.no_grad():
        got, gmask = models["augment"].module(*_torch(x, m))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_masked_embed_equals_embed_of_the_crop():
    """GeM-VGG16 on a padded bucket with its mask equals the net on the
    exact crop (tests/test_finetune_step.py:38 for the pooling alone)."""
    _, _, models = _pair("instance")
    net = models["embed"].module.eval()
    imgs, masks, _, _ = _batch(seed=2)
    x, m = _torch(imgs[0], masks[0])
    with torch.no_grad():
        got = net(x, mask=m).numpy()
        for s, (h, w) in enumerate(RECTS):
            want = net(x[s:s + 1, :h, :w].contiguous()).numpy()
            np.testing.assert_allclose(got[s:s + 1], want, rtol=0, atol=1e-5)
    small = np.random.RandomState(0).rand(1, 4, 6, 8).astype(np.float32)
    pad = np.zeros((1, 8, 8, 8), np.float32)
    pad[:, :4, :6] = small
    mk = np.zeros((1, 8, 8), np.float32)
    mk[:, :4, :6] = 1.0
    np.testing.assert_allclose(
        pooling.gem(*_torch(pad), p=3.0, mask=_torch(mk)[0]).numpy(),
        pooling.gem(*_torch(small), p=3.0).numpy(), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 9])
def test_f32_step_matches_jax(seed):
    """float32 end to end (batch-norm generator, as finetune.yml): the loss
    and the descriptors within 1e-5 relative, each parameter's gradient
    within 5e-5 of its norm (2e-6 to 6e-6 measured: the sums of ~15 layers
    over every pixel, in other orders), and the parameters after one Adam step at lr
    1e-3 from the same gradients within 1e-5 relative (both sum in float32
    on the CPU, in other orders).

    Adam's first step moves each weight by lr * g / (|g| + 1e-8): where the
    weight-decayed gradient g is near 0, a float32 difference in the sum
    that made g changes the step by up to lr. So the step is held on the
    same gradients, and the gradients by their norm. The JAX augment chain
    runs eagerly (`_jax_augment`), so its CLAHE rounds as cv2 does."""
    jmodels, variables, models = _pair("batch")
    imgs, masks, _, pmask = _batch(seed=seed)
    want = _jax_descriptors(jmodels, variables, imgs[0], masks[0], pmask[0])
    got = _port_descriptors(models, *_torch(imgs[0], masks[0], pmask[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    fresh = copy.deepcopy(models["embed"].module)
    jloss, jstate, loss, net = _steps(jmodels, variables, models, seed=seed,
                                      tx=_grab_grads())
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    jgrads = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.opt_state}))
    for k, p in net.named_parameters():
        g, want_g = p.grad.numpy(), jgrads[k].numpy()
        assert np.linalg.norm(g - want_g) <= 5e-5 * np.linalg.norm(want_g), k

    # one Adam step from the same gradients on both sides
    params = variables["embed"]["params"]
    tx, _ = j_opt(dict(ADAM), group_mults=param_group_mults("cirnet", params))
    updates, _ = tx.update(jstate.opt_state, tx.init(params), params)
    jnew = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": optax.apply_updates(params, updates)}))
    opt, _ = initialize_optimizer(dict(ADAM), fresh.named_parameters(),
                                  "cirnet")
    for k, p in fresh.named_parameters():
        p.grad = jgrads[k].clone()
    opt.step()
    for k, p in fresh.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jnew[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_bf16_step_matches_jax():
    """The embed computing in bf16 (`runtime.dtype`, bench.py:378) on both
    sides, the port's conv1_2 and conv2_2 through K2's plain version: the
    descriptors within 2e-2 and the loss within 1%; the master parameters
    stay float32 and move."""
    jmodels, variables, models = _pair("instance", dtype="bfloat16")
    imgs, masks, _, pmask = _batch(seed=3)
    want = _jax_descriptors(jmodels, variables, imgs[0], masks[0], pmask[0])
    got = _port_descriptors(models, *_torch(imgs[0], masks[0], pmask[0]))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    before = {k: v.clone() for k, v in
              models["embed"].module.state_dict().items()}
    jloss, _, loss, net = _steps(jmodels, variables, models, seed=3)
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert any(not torch.equal(v, before[k])
               for k, v in net.state_dict().items())


def test_fakebatch_grads_equal_plain_batch_grads():
    """Per-tuple backward with .grad accumulation equals one backward of the
    summed loss (the same total, the same gradients)."""
    _, _, models = _pair("instance")
    imgs, masks, labels, pmask = _torch(*_batch())
    net = models["embed"].module
    grads, losses = [], []
    for fakebatch in (True, False):
        opt = torch.optim.SGD(net.parameters(), lr=0.0)
        step = supervised.build_finetune_step(models, opt, _criterion(),
                                              fakebatch=fakebatch)
        _, m = step(supervised.make_finetune_state(models, opt), imgs, masks,
                    labels, pmask)
        losses.append(float(m["total"]))
        grads.append([p.grad.clone() for p in net.parameters()])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-9)


def test_model_positions_equal_the_full_generator_run():
    """The generator on the anchor only gives what the full run gives: the
    gate passes no other row."""
    _, _, models = _pair("instance")
    imgs, masks, _, pmask = _torch(*_batch(seed=4))
    out = []
    with torch.no_grad():
        for positions in ((0,), None):
            x, m = models["augment"].apply(
                imgs[0], ctx={"pass_mask": pmask[0]}, train=True,
                model_positions=positions, mask=masks[0])
            out.append((x.numpy(), m.numpy()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_empty_selection_under_multiscale_is_refused():
    """`model_positions=()` skips the module; under a multiscale wrapper
    that would hand back each scaled input as if it were the module's
    output, so the port raises (ROADMAP §C)."""
    _, _, models = _pair("instance")
    net = models["embed"]
    net.wrappers_train = [wrappers.CirMultiscaleAggregation(scales=True)]
    assert len(net.wrappers_train[0].scales) == 3
    x = torch.zeros((2, B, B, 3))
    with pytest.raises(ValueError, match="multiscale"):
        net.apply(x, train=True, model_positions=())


def test_finetune_tree_round_trips_through_the_jax_importer():
    """{"augment", "embed"} variables -> port state dicts (gem_p and the
    batch statistics included) -> the JAX importer -> the same arrays."""
    jmodels, variables, models = _pair("batch")
    for name, arch in (("augment", ""), ("embed", "cirnet")):
        state = {k: v.numpy() for k, v in
                 models[name].module.state_dict().items()}
        template = jax.tree_util.tree_map(np.zeros_like, jax.tree_util.
                                          tree_map(np.asarray,
                                                   variables[name]))
        back = ti.convert_torch_state(
            template, state, key_map=ti.key_map_for_architecture(arch),
            min_coverage=1.0)
        for leaf_a, leaf_b in zip(jax.tree_util.tree_leaves(back),
                                  jax.tree_util.tree_leaves(variables[name])):
            np.testing.assert_array_equal(np.asarray(leaf_a),
                                          np.asarray(leaf_b))
    assert "pool.p" in models["embed"].module.state_dict()
    assert any(k.endswith("running_var")
               for k in models["augment"].module.state_dict())


def test_gamma_schedule_and_group_rates_match_jax():
    """finetune.yml's gamma 0.99 (and an "exp(x)" string) against the JAX
    schedule; applied to the cirnet groups it gives lr * mult * gamma**e."""
    from gandtr_tpu.learning.schedules import initialize_schedule as j_sched
    from gandtr_tpu_torch.learning.optimizers import set_learning_rate
    from gandtr_tpu_torch.learning.schedules import initialize_schedule
    for gamma in (0.99, "exp(-0.1)"):
        cfg = {"algorithm": "gamma", "gamma": gamma}
        got, want = initialize_schedule(40, cfg), j_sched(40, dict(cfg))
        assert [got(e) for e in range(40)] == [want(e) for e in range(40)]
    assert initialize_schedule(40, {"algorithm": "const"})(7) == 1.0
    _, _, models = _pair("instance")
    opt, base = initialize_optimizer(
        {"algorithm": "adam", "lr": 5e-7, "weight_decay": 5e-4},
        models["embed"].module.named_parameters(), "cirnet")
    set_learning_rate(opt, base, initialize_schedule(
        40, {"algorithm": "gamma", "gamma": 0.99})(3))
    assert sorted(g["lr"] for g in opt.param_groups) == [
        pytest.approx(5e-7 * 0.99 ** 3), pytest.approx(5e-6 * 0.99 ** 3)]


def test_generator_safe_bucket_and_ratio_gate():
    assert generator_safe_bucket(362) == 364
    assert generator_safe_bucket(32) == 32
    assert generator_safe_bucket(10) == 12
    assert finetune_build._parse_ratio(WRAPPERS) == (0.25, "anc")
    assert finetune_build._augment_positions(
        {"runtime": {"wrappers": WRAPPERS}}, {"neg_num": 5}) == (0,)
    names = [hashlib.sha1(str(i).encode()).hexdigest()[:12]
             for i in range(100)]
    got = [wrappers.cir_hash_passthrough(n, 0.25) for n in names]
    assert got == [jwrappers.cir_hash_passthrough(n, 0.25) for n in names]
    assert 5 < sum(got) < 50
    for path in ("a/b/x.jpg", "s.h5#cid7", "plain"):
        assert wrappers.metadata_name(path) == jwrappers.metadata_name(path)


def test_chip_smoke_config_is_the_published_one():
    """chip_smoke.py's fine-tune tree is finetune.yml's network and learning
    sections as published, with only the checkpoints out of reach (augment
    path null, embed not pretrained) and the embed in bf16 (bench.py:378);
    its data section takes the published train values it names."""
    import yaml

    import chip_smoke
    with open("gandtr_tpu/scenarios/configs/iccv23/parameters/"
              "finetune.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["network"]["augment"]["path"] = None
    cfg["network"]["embed"]["model"]["pretrained"] = False
    cfg["network"]["embed"]["runtime"]["dtype"] = "bfloat16"
    smoke = chip_smoke.finetune_config()
    assert smoke["network"] == cfg["network"]
    assert smoke["learning"] == cfg["learning"]
    for part in ("dataset", "loader"):
        for k, v in smoke["data"]["train"][part].items():
            assert cfg["data"]["train"][part][k] == v, (part, k)
    assert chip_smoke.finetune_config(None)["network"]["embed"]["runtime"][
        "dtype"] is None


def test_experiment_builds_finetune_yml_on_the_cpu():
    """The published finetune.yml networks (the generator cut to ngf 4 and
    one block, embed in bf16) through the uint8 entry point: a finite loss,
    embed parameters moved, the frozen generator untouched. Its tuple
    database (SfM-120k) is not in the repository, so the experiment is
    built without `dataset_pkl`: a step and no loader (the loop is
    tests/test_torch_finetune_loop.py's)."""
    import yaml
    with open("gandtr_tpu/scenarios/configs/iccv23/parameters/"
              "finetune.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["network"]["augment"]["path"] = None
    cfg["network"]["augment"]["model"].update(ngf=4, n_blocks=1)
    cfg["network"]["embed"]["runtime"]["dtype"] = "bfloat16"
    del cfg["data"]["train"]["dataset"]["dataset_pkl"]
    exp = finetune_build.build_finetune_experiment(cfg, device="cpu")
    assert exp["bucket"] == 364
    assert exp["loader"] is None and exp["training"] is None
    rng = np.random.RandomState(5)
    imgs = rng.randint(0, 256, (1, 7, B, B, 3)).astype(np.uint8)
    hws = np.asarray([[(30, 26), (26, 30)] * 3 + [(32, 32)]], np.int32)
    labels = np.asarray([[-1, 1, 0, 0, 0, 0, 0]], np.float32)
    pmask = np.zeros((1, 7), bool)
    pmask[0, 0] = True
    nets = {k: m.module for k, m in exp["models"].items()}
    before = {k: {n: v.clone() for n, v in net.state_dict().items()}
              for k, net in nets.items()}
    state, m = exp["step"](exp["state"], *_torch(imgs, hws, labels, pmask))
    assert state.step == 1 and np.isfinite(float(m["total"]))
    moved = {k: any(not torch.equal(v, before[k][n])
                    for n, v in net.state_dict().items())
             for k, net in nets.items()}
    assert moved == {"augment": False, "embed": True}
    groups = exp["state"].optimizer.param_groups
    assert sorted((g["lr"], g["weight_decay"]) for g in groups) == [
        pytest.approx((5e-7, 5e-4)), pytest.approx((5e-6, 0.0))]


def test_experiment_refuses_a_transform_it_cannot_stage():
    """The step stages uint8 tuples on the device; an augment transform
    with a host step before `totensor` (here a resize) has no device part,
    and the experiment refuses it instead of taking float images."""
    import yaml
    with open("gandtr_tpu/scenarios/configs/iccv23/parameters/"
              "finetune.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["network"]["augment"]["path"] = None
    cfg["network"]["augment"]["model"].update(ngf=4, n_blocks=1)
    cfg["network"]["augment"]["runtime"]["data"]["transforms"] = \
        "pil2np | resize:64 | totensor | normalize"
    with pytest.raises(NotImplementedError, match="stages uint8"):
        finetune_build.build_finetune_experiment(cfg, device="cpu")
