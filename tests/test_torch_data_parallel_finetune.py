"""The port's data-parallel fine-tune step (scenarios/finetune_build.py
over parallel/mesh.py) against the JAX package's, on the CPU: two gloo
ranks (tests/torch_dp_workers.py, which import only the port) against the
JAX step wrapped as the JAX finetune_build wraps it
(`_maybe_data_parallel` -> `parallel.mesh.data_parallel_step` over a
2-device mesh of the 8 CPU devices), and against the port's single
process.

tests/test_torch_finetune.py's template: a batch-norm generator of ngf 4
and one block in the augment net with the published wrapper chain, the
full-width GeM-VGG16, a 32 bucket, here T = 4 tuples of S = 3 (2 a rank)
as uint8 with each image's valid size, through the port's whole build.
The JAX step takes the port's augmented tuples (the augment chain is held
to JAX's in tests/test_torch_finetune.py; JAX's runs eagerly there, 6 s a
tuple). The contrastive loss sums over the tuples, so the step's gradient
is the sum of the ranks' gradients: DistributedDataParallel's averaging
would halve it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.learning import supervised as jsup
from gandtr_tpu.parallel import mesh as jmesh
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_finetune import ADAM, _configs, _grab_grads, _jax_pair
from torch_dp_workers import finetune_step, spawn

torch.set_num_threads(1)

S, B = 3, 32
RECTS = [(30, 26), (26, 30), (32, 28)]


def _params(parallel, batch_size):
    acfg, ecfg = _configs("batch")
    return {"network": {"augment": acfg, "embed": ecfg},
            "learning": {"training": {
                "optimizer": dict(ADAM), "seed": 0, "epochs": 1,
                "criterion": {"loss": "contrastive", "margin": 0.75},
                "parallel": parallel}},
            "data": {"train": {"loader": {"batch_size": batch_size},
                               "dataset": {"image_size": B, "neg_num": 1}}}}


def _batch(T, seed=0):
    """uint8 tuples with a zero band, their valid sizes, labels, and the
    anchors of tuples 0 and 2 passed through the generator."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((T, S, B, B, 3), np.uint8)
    hws = np.zeros((T, S, 2), np.int32)
    for t in range(T):
        for s, (h, w) in enumerate(RECTS):
            imgs[t, s, :h, :w] = rng.randint(0, 256, (h, w, 3))
            hws[t, s] = (h, w)
    labels = np.asarray([[-1, 1, 0]] * T, np.float32)
    pmask = np.zeros((T, S), bool)
    pmask[::2, 0] = True
    return imgs, hws, labels, pmask


def _augmented(weights, imgs, hws, pmask):
    """The port's augment chain on the staged tuples (the build's `stage`,
    then the generator's wrappers on the anchors the gate passes): the
    images the descriptor net takes, and their valid masks."""
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    exp = build_finetune_experiment(_params(False, 4), device="cpu")
    augment = exp["models"]["augment"]
    augment.module.load_state_dict(weights["augment"], strict=True)
    x, m = exp["stage"](torch.from_numpy(imgs), torch.from_numpy(hws))
    xs, ms = [], []
    with torch.no_grad():
        for t in range(x.shape[0]):
            y, k = augment.apply(x[t], ctx={"pass_mask": torch.from_numpy(
                pmask[t])}, train=True, model_positions=(0,), mask=m[t])
            xs.append(y.numpy())
            ms.append(k.numpy())
    return np.stack(xs), np.stack(ms)


@pytest.fixture(scope="module")
def runs():
    jmodels, variables = _jax_pair("batch")
    weights = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                        variables))
    batch = _batch(4)
    ax, am = _augmented(weights, batch[0], batch[1], batch[3])
    step = jmesh.data_parallel_step(
        jsup.build_finetune_step({"embed": jmodels["embed"]},
                                 _grab_grads(), margin=0.75, fakebatch=True),
        jmesh.make_mesh(2))
    jstate, jm = step(jsup.make_finetune_state(variables, _grab_grads()),
                      jnp.asarray(ax), jnp.asarray(am),
                      jnp.asarray(batch[2]), jnp.asarray(batch[3]))
    jgrads = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.opt_state}))
    return {"jax": (float(jm["total"]), jgrads), "weights": weights,
            "ranks": spawn("finetune_step", params=_params({"devices": 2}, 4),
                           batch=batch, weights=weights),
            "single": finetune_step(_params(True, 4), batch, weights)}


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def test_two_ranks_match_jax_two_devices(runs):
    """The 2-rank step against JAX's 2-device step: the loss within 1e-5
    relative, each parameter's gradient within 5e-5 of its norm (the
    single process's bounds, tests/test_torch_finetune.py); both ranks
    step with the same gradients."""
    jloss, jgrads = runs["jax"]
    r0, r1 = runs["ranks"]
    assert r0["data_parallel"] and r1["data_parallel"]
    np.testing.assert_allclose(r0["loss"], jloss, rtol=1e-5)
    assert r0["loss"] == r1["loss"]
    for k, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][k]), k
        assert _rel(g, jgrads[k]) <= 5e-5, k


def test_contrastive_gradient_is_summed_not_averaged(runs):
    """The 2-rank gradient is the single process's (within 1e-6 of its
    norm: the ranks' sums add in another order), so the sum-reduced loss
    is not divided by the world size; averaged, as DDP averages, it would
    be half of it, 0.5 of its norm away."""
    r0 = runs["ranks"][0]
    one = runs["single"]
    assert not one["data_parallel"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-6)
    for k, g in one["grads"].items():
        assert _rel(r0["grads"][k], g) <= 1e-6, k
        assert _rel(r0["grads"][k] / 2, g) >= 0.49, k


def test_weights_after_adam(runs):
    """Adam from those gradients: every embed weight of the 2-rank step
    within 2 lr of the single process's (where a gradient is near 0 its
    sign may differ), the frozen augment net unchanged, both ranks equal."""
    r0, r1 = runs["ranks"]
    one = runs["single"]
    for name in ("augment", "embed"):
        for k, v in one["state"][name].items():
            got = r0["state"][name][k]
            assert torch.equal(got, r1["state"][name][k]), (name, k)
            if name == "augment":
                assert torch.equal(got, runs["weights"][name][k]), k
            else:
                assert float((got - v).abs().max()) <= 2 * ADAM["lr"], k


def test_indivisible_batch_warns_and_runs_the_whole_step(runs):
    """A batch of 3 over 2 ranks (finetune.yml's 5 does not divide
    either): JAX's warning, then every rank runs the whole step, bit for
    bit the single process's."""
    batch = _batch(3, seed=1)
    r0, r1 = spawn("finetune_step", params=_params({"devices": 2}, 3),
                   batch=batch, weights=runs["weights"])
    assert "data-parallel disabled: batch 3 not divisible by 2 devices" \
        in r0["warnings"]
    assert not r0["data_parallel"]
    one = finetune_step(_params(True, 3), batch, runs["weights"])
    for r in (r0, r1):
        assert r["loss"] == one["loss"]
        for k, g in one["grads"].items():
            assert torch.equal(r["grads"][k], g), k
