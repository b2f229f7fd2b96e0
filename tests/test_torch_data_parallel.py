"""The port's data-parallel GAN training (gandtr_tpu_torch/parallel/
mesh.py, scenarios/build.py) against the JAX package's, on the CPU: two
gloo ranks started with torch.multiprocessing (tests/torch_dp_workers.py,
which import only the port) against JAX's step over a 2-device mesh of
the 8 CPU devices tests/conftest.py provides (`parallel: {devices: 2}`,
jitted), and against the port's single process.

The scenario is tests/test_dp_train_stage.py's micro HED-GAN (instance
norm, 16x16), with a global batch of 4, and the same with a batch-norm
generator: its BatchNorm normalizes by the global batch's statistics on
both ranks (an all-reduce that autograd carries back), as GSPMD's does.
Then HED^N-GAN's micro train stage (tests/torch_gan_common.py, a
batch-norm generator and discriminator) over two ranks, resumed from a
copy after epoch 1: the resumed run writes the straight run's epoch-2
files bit for bit."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.scenarios.build import build_gan_experiment as j_build
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_dp_train_stage import _scenario
from torch_dp_workers import gan_steps, spawn
from torch_gan_common import micro_config, shape_init

torch.set_num_threads(1)

STEPS, BATCH, SIDE, LR = 2, 4, 16, 2e-4
METRICS = ("total", "D_real", "D_fake", "G_gan", "G_hed")


def _batches(seed=0):
    rs = np.random.RandomState(seed)
    return [tuple(rs.uniform(-1, 1, (BATCH, SIDE, SIDE, 3))
                  .astype(np.float32) for _ in range(2))
            for _ in range(STEPS)]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def all_runs():
    """{norm: JAX's 2-device run, the port's 2-rank run and its single
    process}, STEPS steps each from the same weights on the same
    batches."""
    return {norm: _runs(norm) for norm in ("instance", "batch")}


@pytest.fixture(params=["instance", "batch"])
def runs(all_runs, request):
    return all_runs[request.param]


def _runs(norm):
    sc = _scenario({"devices": 2})
    sc["network"]["generator_X"]["model"]["norm_layer"] = norm
    batches = _batches()
    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        jexp = j_build(copy.deepcopy(sc), sample_hw=SIDE, batch_size=BATCH,
                       data_override={})
    assert getattr(jexp["step"], "gandtr_dp", False)
    weights = from_jax_variables(_host(jexp["variables"]))
    jstate, jmetrics = jexp["state"], []
    for X, Y in batches:
        jstate, m, _ = jexp["step"](jstate, jnp.asarray(X), jnp.asarray(Y))
        jmetrics.append({k: float(v) for k, v in m.items()})
    return {"norm": norm, "weights": weights,
            "jax": (jmetrics, from_jax_variables(_host(jstate.variables))),
            "ranks": spawn("gan_steps", cfg=sc, batches=batches,
                           weights=weights),
            "single": gan_steps(sc, batches, weights)}


def test_two_ranks_match_jax_two_devices(runs):
    """The port's 2-rank step against JAX's 2-device step after each step:
    every metric within rtol 1e-4 / atol 1e-6 (the single process's bound
    against JAX, tests/test_torch_gan_step.py), every trained parameter
    within 2 lr per Adam step, every BatchNorm statistic within 1e-5; both
    ranks hold the same metrics and weights."""
    jmetrics, jvars = runs["jax"]
    r0, r1 = runs["ranks"]
    assert r0["data_parallel"] and r1["data_parallel"]
    for jm, pm, pm1 in zip(jmetrics, r0["metrics"], r1["metrics"]):
        assert pm == pm1
        for k in METRICS:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for name in ("generator_X", "discriminator_Y"):
        for key, want in jvars[name].items():
            got = r0["state"][name][key]
            assert torch.equal(got, r1["state"][name][key]), (name, key)
            if key.endswith("num_batches_tracked"):
                continue
            diff = float((got.double() - want.double()).abs().max())
            bound = 1e-5 if key.endswith(("running_mean", "running_var")) \
                else 2 * LR * STEPS
            assert diff <= bound, (name, key, diff)


def test_two_ranks_match_one_process(runs):
    """The same step in one process: the metrics within rtol 1e-4 / atol
    1e-6, the weights within 2 lr per step, the BatchNorm statistics
    within 1e-5 (the two sum the global batch in other orders); the
    single process's build is not data-parallel. The debug images are the
    global batch's last row."""
    r0, _ = runs["ranks"]
    one = runs["single"]
    assert not one["data_parallel"]
    for pm, sm in zip(r0["metrics"], one["metrics"]):
        for k in METRICS:
            np.testing.assert_allclose(pm[k], sm[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for name, sd in one["state"].items():
        for key, want in sd.items():
            diff = float((r0["state"][name][key].double()
                          - want.double()).abs().max())
            bound = 1e-5 if "running" in key or "tracked" in key \
                else 2 * LR * STEPS
            assert diff <= bound, (name, key, diff)
    X = torch.from_numpy(_batches()[-1][0])
    assert torch.equal(r0["debug"]["real_X"], X[-1])
    assert torch.equal(runs["ranks"][1]["debug"]["real_X"], X[-1])


def test_batch_norm_is_global(all_runs):
    """Without the all-reduce each rank would normalize by its own two
    rows: the running statistics after the run are the global batch's,
    so they match the single process's (above) and not those of a rank's
    rows alone."""
    runs = all_runs["batch"]
    sc = _scenario(False)
    sc["network"]["generator_X"]["model"]["norm_layer"] = "batch"
    half = [(X[:BATCH // 2], Y[:BATCH // 2]) for X, Y in _batches()]
    alone = gan_steps(sc, half, runs["weights"])
    key = next(k for k in runs["single"]["state"]["generator_X"]
               if k.endswith("running_mean"))
    got = runs["ranks"][0]["state"]["generator_X"][key]
    want = runs["single"]["state"]["generator_X"][key]
    local = alone["state"]["generator_X"][key]
    assert float((got - want).abs().max()) <= 1e-5
    assert float((local - want).abs().max()) > 1e-3


def test_short_last_batch_runs_the_whole_step(all_runs):
    """A loader's short last batch (3 rows over 2 ranks, after a step of
    4) with the batch-norm generator: JAX's warning, then every rank runs
    the whole step on all 3 rows, so the run stays within the single
    process's bounds of test_two_ranks_match_one_process and the ranks
    hold the same weights. A rank that took its 1 row of the 3 would
    drop the last row from the step and its BatchNorm."""
    runs = all_runs["batch"]
    sc = _scenario({"devices": 2})
    sc["network"]["generator_X"]["model"]["norm_layer"] = "batch"
    first, last = _batches(seed=3)
    batches = [first, (last[0][:3], last[1][:3])]
    r0, r1 = spawn("gan_steps", cfg=sc, batches=batches,
                   weights=runs["weights"])
    one = gan_steps(sc, batches, runs["weights"])
    assert r0["data_parallel"] and r1["data_parallel"]
    assert "data-parallel disabled: batch 3 not divisible by 2 devices" \
        in r0["warnings"]
    for pm, sm in zip(r0["metrics"], one["metrics"]):
        for k in METRICS:
            np.testing.assert_allclose(pm[k], sm[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for name, sd in one["state"].items():
        for key, want in sd.items():
            got = r0["state"][name][key]
            assert torch.equal(got, r1["state"][name][key]), (name, key)
            diff = float((got.double() - want.double()).abs().max())
            bound = 1e-5 if "running" in key or "tracked" in key \
                else 2 * LR * STEPS
            assert diff <= bound, (name, key, diff)
    X = torch.from_numpy(batches[-1][0])
    assert torch.equal(r0["debug"]["real_X"], X[-1])
    assert torch.equal(r1["debug"]["real_X"], X[-1])


def test_resume_on_two_ranks_is_bit_for_bit(tmp_path):
    """HED^N-GAN's micro train stage over two ranks (batch 2, one row a
    rank; 2 epochs of 4 steps): a copy of the directory after epoch 1,
    resumed, writes epoch 2's network and training files as the straight
    run does, bit for bit. Rank 0 alone wrote them."""
    cfg = micro_config(str(tmp_path))
    cfg["learning"]["training"]["parallel"] = {"devices": 2}
    r0, r1 = spawn("gan_resume", cfg=cfg, root=str(tmp_path / "runs"))
    assert r0["start"] == r1["start"] == 2
    assert not any("not divisible" in w for w in r0["warnings"])
    a, b = r0["files"]["a"], r0["files"]["b"]
    assert sorted(a) == sorted(b) and any(k.endswith(".pkl") for k in a)
    for name in a:
        _same(a[name], b[name], (name,))


def _same(x, y, where):
    if isinstance(x, torch.Tensor):
        assert torch.equal(x, y), where
    elif isinstance(x, dict):
        assert sorted(x, key=str) == sorted(y, key=str), where
        for k in x:
            _same(x[k], y[k], where + (k,))
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            _same(u, v, where + (i,))
    elif isinstance(x, np.ndarray):
        np.testing.assert_array_equal(x, y, err_msg=str(where))
    else:
        assert x == y or (x != x and y != y), where
