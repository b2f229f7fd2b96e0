"""The port's fine-tune loop against the JAX package's on the micro
experiment of tests/test_torch_finetune_loop.py with `clahepost` left out
of the augment net's wrapper chain: (c) the losses, (d) the parameters
after each epoch and (e) events.json.

XLA's CPU jit moves a uint8 level of the JAX masked CLAHE chain off cv2
(ROADMAP C), and the JAX loop runs that chain jitted. On the micro set it
does: with the published chain the first step's loss differs from the
port's by 3.2e-5 relative, and after epoch 1 88,574 of the 14.7 M embed
weights (0.6%) are more than 1.05 lr apart, their first Adam step taken
with the other sign; without `clahepost` the first loss is equal in
float32 and 4 weights are. So the parameters are held here, where the two
chains compute the same function, and (a), (b) and (f) on the published
chain there; the losses and events on both.
"""
import numpy as np
import pytest
import torch

from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu.utils.io import (load_torch_checkpoint,
                                 normalize_network_checkpoint)
from gandtr_tpu_torch.hub import _checkpoint_model_state
from gandtr_tpu_torch.learning.network import build_single_net
from test_torch_finetune_loop import (GAMMA, LR, WRAPPERS_NO_CLAHE, _run_pair,
                                      _synth, check_events, check_losses,
                                      micro_params)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def no_clahe(tmp_path_factory):
    root = tmp_path_factory.mktemp("ftloop_noclahe")
    db, images = _synth(root)
    run = _run_pair(root, "no_clahe", micro_params(WRAPPERS_NO_CLAHE), db,
                    images)
    run.update(db=db, images=images)
    return run


def test_iteration_losses_equal_jax(no_clahe):
    """(c) Each iteration's loss within 1e-4 relative."""
    check_losses(no_clahe)


def test_events_equal_jax(no_clahe):
    """(e) events.json: the same epochs and keys, the values within (c)'s
    tolerance."""
    check_events(no_clahe)


def test_parameters_after_each_epoch_match_jax(no_clahe):
    """(d) The embed parameters after each epoch within 1.05 x the epochs'
    lr x the group's multiplier of the JAX ones, elementwise, but for at
    most 1e-5 of them, which stay within twice that; the generator
    untouched.

    Adam moves each weight by about lr a step whatever its gradient's
    size, so where a gradient is near 0 a float32 difference in it can
    flip the step's sign: the two weights then part by up to 2 lr, not lr.
    4 of the 14.7 M weights (2.7e-7) are past 1.05 lr after epoch 1 here,
    none after epoch 2."""
    budget = 0.0
    for epoch, (jp, pp) in enumerate(zip(no_clahe["jrec"]["params"],
                                         no_clahe["prec"]["params"]), 1):
        budget += LR * GAMMA ** (epoch - 1)
        flipped = total = 0
        for k, want in jp.items():
            lim = 1.05 * budget * (10.0 if k == "pool.p" else 1.0)
            d = (pp[k] - want).abs()
            assert float(d.max()) <= 2 * lim, (epoch, k, float(d.max()), lim)
            flipped += int((d > lim).sum())
            total += d.numel()
        assert flipped <= 1e-5 * total, (epoch, flipped, total)
    aug = no_clahe["pexp"]["models"]["augment"].module.state_dict()
    assert all(torch.equal(v, no_clahe["aug0"][k]) for k, v in aug.items())


def test_port_checkpoint_loads_into_jax(no_clahe):
    """embed_epoch_02.ckpt is the reference's flat torch file: the JAX
    package reads it (normalize_network_checkpoint + convert_torch_state)
    and its mining extraction then gives the port's descriptors within
    1e-5; the port's hub reader loads it strict into a fresh GeM-VGG16."""
    path = str(no_clahe["pdir"] / "epochs" / "embed_epoch_02.ckpt")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert sorted(raw) == ["frozen", "model_state", "network_params", "type"]
    assert raw["frozen"] is False and raw["type"] == "SingleNetwork"
    net = normalize_network_checkpoint(load_torch_checkpoint(path))["net"]
    jvars = ti.convert_torch_state(
        no_clahe["variables"]["embed"], net["model_state"],
        key_map=ti.key_map_for_architecture("cirnet"), min_coverage=1.0)
    jexp = no_clahe["jexp"]
    jexp["dataset"].extract_fn.holder["state"] = no_clahe["jstate"].replace(
        variables={"augment": no_clahe["variables"]["augment"],
                   "embed": jvars})
    idxs = [1, 3, 8, 9, 12]
    want = jexp["dataset"].extract_fn(idxs, label="neg-pool-mine")
    got = no_clahe["pexp"]["dataset"].extract_fn(idxs, label="neg-pool-mine")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    fresh = build_single_net(micro_params()["network"]["embed"])
    fresh.module.load_state_dict(_checkpoint_model_state(raw), strict=True)
