"""The validate stage of `eval_r101` (and of step 4 of `finetune_r101`):
the port's (scenarios/validate_stage.py with a GeM ResNet and a 2048x2048
Lw pickle) against the JAX package's, on the CPU, on
tests/test_torch_eval.py's seeded roxford5k-style set.

The net is tests/test_torch_resnet.py's reduced-depth ResNet (RESNET_T,
2048-d) with the port's seeded weights: the JAX stage loads a reference
.pth, the port's stage the port's own `epochs/embed_best.ckpt`. The Lw is
seeded and well-conditioned (the identity plus 1e-2 noise): an Lw learned
from the few pairs a test can afford is ill-conditioned and turns the two
packages' 1e-6 float32 differences into 1e-4 ones after whitening
(tests/test_torch_whitening.py holds the learned one, at 1e-3). The JAX
chain runs its CLAHE on the host, eagerly, as tests/test_torch_eval.py
runs it.

Tolerances: 1e-4 on unit-norm float32 descriptors against the JAX
package, 1e-5 for the port bucketed against exact."""
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from gandtr_tpu.scenarios import validate_stage as jvalidate
from gandtr_tpu_torch.scenarios import validate_stage as tvalidate
from test_torch_eval import DB_SHAPES, QUERY_BBX, QUERY_SHAPES, _image
from test_torch_resnet import reduced_resnet, seeded_net
from test_torch_whitening import (IMNET, R_MODEL, TRANSFORMS, _jax_host,
                                  write_network_files)

torch.set_num_threads(1)

__all__ = ["reduced_resnet"]    # the module-scoped RESNET_T fixture


def seeded_lw(path, dim=2048, seed=4):
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        pickle.dump({"P": (np.eye(dim) + 0.01 * rng.randn(dim, dim)).astype(
            np.float32), "m": (0.01 * rng.randn(dim, 1)).astype(np.float32)},
            f)
    return path


def write_eval_set(root, seed=0):
    """tests/test_torch_eval.py's roxford5k-style set under root."""
    jpg = os.path.join(root, "roxford5k", "jpg")
    os.makedirs(jpg)
    rng = np.random.RandomState(seed)
    groups = [i % 3 for i in range(len(DB_SHAPES))]
    for i, (h, w) in enumerate(DB_SHAPES):
        _image(rng, h, w, groups[i]).save(os.path.join(jpg, "db%d.jpg" % i))
    gnd = []
    for q, ((h, w), bbx) in enumerate(zip(QUERY_SHAPES, QUERY_BBX)):
        _image(rng, h, w, q).save(os.path.join(jpg, "q%d.jpg" % q))
        same = [i for i, g in enumerate(groups) if g == q]
        other = [i for i, g in enumerate(groups) if g != q]
        gnd.append({"easy": np.asarray(same[:2]),
                    "hard": np.asarray(same[2:]),
                    "junk": np.asarray(other[:1]), "bbx": bbx})
    with open(os.path.join(root, "roxford5k", "gnd_roxford5k.pkl"),
              "wb") as f:
        pickle.dump({"imlist": ["db%d" % i for i in range(len(DB_SHAPES))],
                     "qimlist": ["q%d" % q for q in range(len(QUERY_SHAPES))],
                     "gnd": gnd}, f)


def eval_params(net_path, lw_path, dir_main, bucket=64, model=R_MODEL):
    """eval.yml's sections at a test size, as finetune_r101's step 4 and
    eval_r101 set them."""
    return {
        "network": {"type": "SingleNetwork", "path": net_path,
                    "model": dict(model),
                    "runtime": {"wrappers": {"eval": {
                        "0_cirwhiten": {"whitening": lw_path,
                                        "dimensions": None},
                        "1_cirmultiscale": {"scales": True}}}}},
        "data": {"image_size": 64, "shape_bucket": bucket,
                 "transforms": TRANSFORMS, "mean_std": IMNET},
        "validation": {"dir_main": dir_main, "datasets": ["roxford5k"]},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reduced_resnet):
    """The JAX validate (from the .pth) and the port's, bucketed (from the
    .ckpt) and exact: (metadata, (metrics, aps, vecs, qvecs)) each."""
    root = str(tmp_path_factory.mktemp("eval_r101"))
    pth, ckpt = write_network_files(root, seeded_net(R_MODEL, seed=2).eval(),
                                    R_MODEL)
    write_eval_set(root)
    lw = seeded_lw(os.path.join(root, "lw.pkl"))
    out = {}
    (res,), rec = chip_smoke._recorded(jvalidate, lambda: jvalidate.validate(
        _jax_host(eval_params(pth, lw, root)), ()))
    out["jax"] = (res["metadata"]["validation"], rec[0])
    for bucket in (64, None):
        (res,), rec = chip_smoke._recorded(
            tvalidate, lambda: tvalidate.validate(
                eval_params(ckpt, lw, root, bucket=bucket), None,
                device="cpu"))
        out[bucket] = (res["metadata"]["validation"], rec[0])
    return out


def test_descriptors_match_jax(runs):
    _, (_, _, jv, jq) = runs["jax"]
    _, (_, _, tv, tq) = runs[64]
    assert tv.shape == (2048, len(DB_SHAPES)) and tq.shape == (2048, 2)
    np.testing.assert_allclose(np.linalg.norm(tv, axis=0), 1.0, atol=1e-5)
    np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tq, jq, atol=1e-4, rtol=0)


def test_maps_equal_jax(runs):
    """Equal metadata (mAPs and keys), once each query's database is shown
    to be ordered by the JAX scores with gaps wider than twice the largest
    difference between the two packages' scores (the seeded net's
    descriptors lie close together, so the gaps are small)."""
    jmeta, (_, _, jv, jq) = runs["jax"]
    tmeta, (_, _, tv, tq) = runs[64]
    js = jv.T.astype(np.float64) @ jq.astype(np.float64)
    ts = tv.T.astype(np.float64) @ tq.astype(np.float64)
    gaps = np.diff(np.sort(js, axis=0), axis=0)
    assert gaps.min() > 2 * np.abs(ts - js).max()
    assert tmeta == jmeta


def test_bucketed_equals_exact(runs):
    (mb, (metrics_b, _, vb, qb)), (me, (metrics_e, _, ve, qe)) = \
        runs[64], runs[None]
    np.testing.assert_allclose(vb, ve, atol=1e-5, rtol=0)
    np.testing.assert_allclose(qb, qe, atol=1e-5, rtol=0)
    assert metrics_b == metrics_e
    assert (mb["config:data.shape_bucket"], me["config:data.shape_bucket"]) \
        == (64, None)
