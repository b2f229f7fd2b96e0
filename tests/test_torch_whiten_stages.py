"""The port's whitening stages (scenarios/stages.py) against the JAX
package's (gandtr_tpu/scenarios/stages.py) on seeded (D, N) descriptors,
at tests/test_torch_whitening.py's bound for the float64 learning (1e-10);
the no-eps NaN columns and the pass-through without a learned whitening
as the JAX stages give them."""
import pickle

import numpy as np
import pytest

from gandtr_tpu.scenarios import stages as jstages
from gandtr_tpu_torch.scenarios import run
from gandtr_tpu_torch.scenarios import stages

TOL = 1e-10


def _vecs(D=16, N=30, seed=0):
    X = np.random.RandomState(seed).randn(D, N)
    return (X / np.linalg.norm(X, axis=0)).astype(np.float32)


def _close(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    else:
        assert got == want


def _both(name, params, data):
    return (stages.FUNCTIONS[name](dict(params), data),
            jstages.FUNCTIONS[name](dict(params), data))


def test_the_stage_names_are_the_jax_ones():
    assert sorted(stages.FUNCTIONS) == sorted(jstages.FUNCTIONS)
    for name in stages.FUNCTIONS:
        assert name in run.FUNCTIONS


@pytest.mark.parametrize("output", [False, True])
def test_learn_lw_whitening_equals_jax(tmp_path, output):
    X = _vecs()
    params = {"qidxs": list(range(10)), "pidxs": list(range(10, 20))}
    if output:
        params["output"] = str(tmp_path / "w" / "lw.pkl")
    got, want = _both("gandtr_tpu.stages.whiten.learn_lw_whitening", params,
                      (X,))
    if output:
        assert got[0] == want[0] == {"whitening": params["output"]}
        _close(got[1], want[1])
    else:
        _close(got, want)


@pytest.mark.parametrize("shrink", [None, 5])
def test_learn_pca_whitening_equals_jax(shrink):
    got, want = _both("gandtr_tpu.stages.whiten.learn_pca_whitening",
                      {"shrink": shrink}, (_vecs(),))
    _close(got, want)


@pytest.mark.parametrize("dimensions", [None, 8])
@pytest.mark.parametrize("as_file", [False, True])
def test_whiten_stage_equals_jax(tmp_path, dimensions, as_file):
    X = _vecs()
    lw = {"m": X[:, :10].mean(axis=1, keepdims=True).astype(np.float64),
          "P": np.random.RandomState(3).randn(16, 16)}
    if as_file:
        path = str(tmp_path / "lw.pkl")
        with open(path, "wb") as f:
            pickle.dump(lw, f)
        lw = path
    got, want = _both("gandtr_tpu.stages.whiten.whiten",
                      {"whitening": lw, "dimensions": dimensions}, (X,))
    _close(got, want)
    assert got[1].shape == (dimensions or 16, 30)


def test_whiten_stage_passes_through_without_whitening():
    X = _vecs()
    got, want = _both("gandtr_tpu.stages.whiten.whiten",
                      {"whitening": None}, (X, "names"))
    assert got[0] == want[0] == {"status": "No whitening applied"}
    assert got[1] is X and got[2] == want[2] == "names"


@pytest.mark.parametrize("dimensions", [None, 6])
def test_paste_pca_normalize_equals_jax(dimensions):
    data = (_vecs(D=8, N=12, seed=1), _vecs(D=5, N=12, seed=2))
    got, want = _both("gandtr_tpu.stages.whiten.paste_pca_normalize",
                      {"dimensions": dimensions}, data)
    _close(got, want)
    empty = np.zeros((0,))
    got, want = _both("gandtr_tpu.stages.whiten.paste_pca_normalize",
                      {"dimensions": 0}, (empty,))
    assert got[1] is empty and want[1] is empty


def test_l2_normalize_keeps_the_nan_columns():
    X = _vecs(D=6, N=5)
    X[:, 1] = 0.0
    X[2, 3] = np.nan
    got, want = _both("gandtr_tpu.stages.whiten.l2_normalize", {}, (X,))
    assert np.array_equal(np.isnan(got[1]), np.isnan(want[1]))
    assert np.isnan(got[1][:, [1, 3]]).all()
    ok = ~np.isnan(want[1])
    np.testing.assert_allclose(got[1][ok], want[1][ok], atol=TOL, rtol=0)
