"""The port's data-parallel serving artifacts (gandtr_tpu_torch/serving/
export.py::export_sharded_model, and `load_artifact(path, devices=...)`)
on the CPU with devices=["cpu", "cpu"]: the sharded generator and
descriptor artifacts against the unsharded artifact of the same model
and against the JAX package's `export_sharded_model` artifact of the same
weights on two of the 8 CPU devices, each within the served path's rule
(the generator's 1 uint8 level, the descriptor's 1e-4: a program of one
row and one of two may round a convolution differently); round-robin
chunks, bit for bit; and the device count a sharded artifact needs."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from gandtr_tpu.serving.export import (export_sharded_model as jax_sharded,
                                       load_artifact as jax_load)
from gandtr_tpu_torch.serving.export import (export_hub_model,
                                             export_sharded_model,
                                             load_artifact)
from torch_serving_common import (EMB_HW, GEN_HW, embedding_pair,
                                  generator_pair, images)

torch.set_num_threads(2)

CPUS = ["cpu", "cpu"]


@pytest.fixture(scope="module", params=["generator", "embedding"])
def artifacts(request, tmp_path_factory):
    """Both packages' model, the port's sharded (2 devices, 1 row each)
    and unsharded (bucket 2) artifacts, and JAX's sharded artifact."""
    kind = request.param
    jm, tm = generator_pair() if kind == "generator" \
        else embedding_pair(multiscale=False)
    hw = GEN_HW if kind == "generator" else EMB_HW
    root = tmp_path_factory.mktemp(kind)
    meta = export_sharded_model(tm, str(root / "sharded"), hw, 2)
    export_hub_model(tm, str(root / "plain"), hw, batch_buckets=(2,))
    jax_sharded(jm, str(root / "jax"), hw, 2, devices=jax.devices()[:2])
    return {"kind": kind, "hw": hw, "meta": meta, "root": root}


def test_meta_and_files(artifacts):
    """One program at batch_per_device rows; the JAX package's `sharded`
    record; the bucket is the whole batch of the devices."""
    root, meta = artifacts["root"], artifacts["meta"]
    assert sorted(os.listdir(root / "sharded")) == ["b1.pt2", "meta.json"]
    with open(root / "sharded" / "meta.json") as f:
        assert json.load(f) == meta
    with open(root / "jax" / "meta.json") as f:
        jmeta = json.load(f)
    assert meta["sharded"] == jmeta["sharded"] == {
        "n_devices": 2, "axis": "data", "batch_per_device": 1}
    assert meta["batch_buckets"] == jmeta["batch_buckets"] == [2]
    assert meta["kind"] == jmeta["kind"] == artifacts["kind"]


def test_sharded_equals_unsharded_and_jax(artifacts):
    """5 images (two whole batches and a padded one): the sharded artifact
    against the unsharded one and JAX's sharded artifact, within the
    served path's rule."""
    root, hw = artifacts["root"], artifacts["hw"]
    x = images(5, hw, seed=3)
    got = load_artifact(str(root / "sharded"), device="cpu",
                        devices=CPUS)(x)
    plain = load_artifact(str(root / "plain"), device="cpu")(x)
    want = jax_load(str(root / "jax"), devices=jax.devices()[:2])(x)
    assert got.shape == plain.shape == want.shape
    for other in (plain, want):
        if artifacts["kind"] == "generator":
            assert got.dtype == np.uint8
            assert int(np.abs(got.astype(int) - other.astype(int)).max()) \
                <= 1
        else:
            np.testing.assert_allclose(got, other, rtol=0, atol=1e-4)


def test_round_robin_and_device_count(artifacts):
    """An unsharded artifact over two devices sends its chunks round-robin
    (bit for bit the one device's); a sharded one needs exactly its
    n_devices, with JAX's message."""
    root, hw = artifacts["root"], artifacts["hw"]
    x = images(5, hw, seed=4)
    rr = load_artifact(str(root / "plain"), device="cpu", devices=CPUS)
    np.testing.assert_array_equal(
        rr(x), load_artifact(str(root / "plain"), device="cpu")(x))
    for devices in (["cpu"], ["cpu"] * 3):
        with pytest.raises(ValueError, match="needs exactly 2 devices, "
                                             "got %d" % len(devices)):
            load_artifact(str(root / "sharded"), device="cpu",
                          devices=devices)
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        export_sharded_model(generator_pair()[1], str(root / "x"), GEN_HW,
                             3, devices=CPUS)
