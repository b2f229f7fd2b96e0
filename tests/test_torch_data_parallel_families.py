"""The port's data-parallel GAN steps of the other families and HED^N-GAN's
knobs over two gloo ranks (tests/torch_dp_workers.py) against the port's
single process, on the CPU at micro size (tests/torch_gan_common.py's
cuts of the shipped parameters files; batches of 4 at 32x32, 2 a rank).
Each single-process step is held to the JAX package's in its own test
file; here the 2-rank step is held to it:

- CycleGAN: the image pools scan the gathered global fakes with the same
  draws on every rank, so both ranks keep one pool, the single
  process's, over steps that fill it and then swap images;
- CUT: the patch positions are drawn once a step from the same generator
  state on every rank, and with `batch_dim_for_bmm: 1` each query's
  negatives are the global batch's keys;
- HED^N-GAN with the teacher cache (the maps of a miss gathered whole, a
  hit's sliced again) and with the device scalecrop (the four uint8
  arguments split by rows); `parallel: {devices: 1}` below the world
  size raises."""
import copy
import os

import numpy as np
import pytest
import torch

from torch_dp_workers import gan_knobs, gan_steps, spawn
from torch_gan_common import ROOT, micro_config, without_data

torch.set_num_threads(1)

STEPS, BATCH, SIDE = 3, 4, 32
PARAMS = os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs", "iccv23",
                      "parameters")


def _batches(n=STEPS, seed=0):
    rs = np.random.RandomState(seed)
    return [tuple(rs.uniform(-1, 1, (BATCH, SIDE, SIDE, 3))
                  .astype(np.float32) for _ in range(2)) for _ in range(n)]


def _family_cfg(root, family):
    cfg = micro_config(root, path=os.path.join(PARAMS,
                                               "train_%s.yml" % family))
    net = cfg["network"]
    if "generator_Y" in net:
        net["generator_Y"]["model"].update(ngf=4, n_blocks=1)
    if "discriminator_X" in net:
        net["discriminator_X"]["model"].update(ndf=4)
    it = cfg["learning"]["training"]["epoch_iteration"]
    if family == "cyclegan":
        it["pool_size"] = 3       # full after the first batch, then swaps
    cfg["learning"]["training"]["parallel"] = {"devices": 2}
    return cfg


def _close(a, b, what):
    for pa, pb in zip(a, b):
        for k in pb:
            np.testing.assert_allclose(pa[k], pb[k], rtol=1e-4, atol=1e-6,
                                       err_msg="%s %s" % (what, k))


@pytest.mark.parametrize("family", ["cyclegan", "cut"])
def test_family_two_ranks_match_one_process(tmp_path, family):
    """STEPS steps: the metrics within rtol 1e-4 / atol 1e-6 of the single
    process's (tests/test_torch_gan_step.py's bound against JAX), equal
    on both ranks; CycleGAN's pools equal on both ranks and the single
    process's within 1e-5 (their images are the fakes, which differ by
    rounding); CUT's `batch_dim_for_bmm` is 1 as shipped."""
    cfg = without_data(_family_cfg(str(tmp_path), family))
    if family == "cut":
        nce = cfg["learning"]["training"]["criterion"]["nce"]
        assert int(nce["batch_dim_for_bmm"]) == 1
    batches = _batches()
    r0, r1 = spawn("gan_steps", cfg=cfg, batches=batches)
    one = gan_steps(cfg, batches)
    assert r0["data_parallel"] and not one["data_parallel"]
    assert r0["metrics"] == r1["metrics"]
    _close(r0["metrics"], one["metrics"], family)
    for name, pool in one["pools"].items():
        p0, p1 = r0["pools"][name], r1["pools"][name]
        assert p0["count"] == p1["count"] == pool["count"] == 3
        assert torch.equal(p0["images"], p1["images"])
        assert torch.equal(p0["generator"], pool["generator"])
        np.testing.assert_allclose(p0["images"].numpy(),
                                   pool["images"].numpy(), rtol=0,
                                   atol=1e-5)
    assert bool(one["pools"]) == (family == "cyclegan")


def test_hedngan_knobs_on_two_ranks(tmp_path):
    """The teacher cache over two ranks: 2 misses then 2 hits, the cached
    run the uncached one bit for bit (each rank's map of a miss is its
    own rows of the gathered map), both within rtol 1e-4 of one process;
    the device scalecrop step over two ranks within rtol 1e-4 of one
    process; `parallel: {devices: 1}` under two ranks raises."""
    cfg = micro_config(str(tmp_path))
    cfg["learning"]["training"]["parallel"] = {"devices": 2}
    batches = _batches(2, seed=5)
    rs = np.random.RandomState(2)
    u8 = []
    for _ in range(2):
        u8.append(rs.randint(0, 256, (BATCH, 40, 40, 3), dtype=np.uint8))
        u8.append(rs.randint(33, 41, (BATCH, 2)).astype(np.int32))
    r0, r1 = spawn("gan_knobs", cfg=cfg, batches=batches, u8_batch=u8)
    assert r0["hits_misses"] == (2, 2) and r0["cache_parallel"]
    for r in (r0, r1):
        assert r["cache"][0] == r["plain"][0]
        for name, sd in r["plain"][1].items():
            for k, v in sd.items():
                assert torch.equal(r["cache"][1][name][k], v), (name, k)
    one_cfg = copy.deepcopy(cfg)
    one_cfg["learning"]["training"]["parallel"] = False
    one = gan_knobs(one_cfg, batches, u8)
    _close(r0["plain"][0], one["plain"][0], "cache")
    assert r0["dsc_parallel"] and not one["dsc_parallel"]
    _close([r0["dsc"]], [one["dsc"]], "device_scalecrop")
    assert "below the process group's world size 2" in r0["refused"]
    assert one["refused"] is None
