"""The port's ranking and mAP (gandtr_tpu_torch/ops/ranking.py) against
the JAX package's (gandtr_tpu/ops/ranking.py) on the same seeded
descriptors and ground truth, on the CPU: ranks, per-query APs, precision@k
and the E/M/H mAPs are equal, ties and junk included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.ops import ranking as jrank
from gandtr_tpu_torch.ops import ranking as trank

torch.set_num_threads(1)


def _descriptors(n_db=40, n_q=6, d=16, seed=0, ties=True):
    """Unit columns; with `ties`, some database columns are exact copies of
    others and one query equals a database column, so equal scores occur."""
    rng = np.random.RandomState(seed)
    vecs = rng.randn(d, n_db).astype(np.float32)
    if ties:
        vecs[:, 7] = vecs[:, 3]
        vecs[:, 21] = vecs[:, 3]
        vecs[:, 30] = vecs[:, 12]
    vecs /= np.linalg.norm(vecs, axis=0, keepdims=True)
    qvecs = rng.randn(d, n_q).astype(np.float32)
    qvecs /= np.linalg.norm(qvecs, axis=0, keepdims=True)
    if ties:
        qvecs[:, 2] = vecs[:, 3]
    return vecs, qvecs


def _gnd(n_db, n_q, seed=1, empty=None):
    """Revisited-style gnd: disjoint easy / hard / junk lists per query;
    query `empty` has no easy and no hard images."""
    rng = np.random.RandomState(seed)
    gnd = []
    for q in range(n_q):
        perm = rng.permutation(n_db)
        easy, hard, junk = perm[:5], perm[5:9], perm[9:12]
        if q == empty:
            easy, hard = perm[:0], perm[:0]
        gnd.append({"easy": easy, "hard": hard, "junk": junk,
                    "bbx": [0, 0, 10, 10]})
    return gnd


@pytest.mark.parametrize("ties", [False, True])
def test_ranks_equal_jax(ties):
    vecs, qvecs = _descriptors(ties=ties)
    want = np.asarray(jrank.rank_descriptors(jnp.asarray(vecs),
                                             jnp.asarray(qvecs)))
    got = trank.rank_descriptors(vecs, qvecs, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (40, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    if ties:
        # the tie keeps the lower database index first
        col = list(got[:, 2].numpy())
        assert col.index(3) < col.index(7) < col.index(21)


def test_ranks_take_tensors_on_their_device():
    vecs, qvecs = _descriptors()
    got = trank.rank_descriptors(torch.from_numpy(vecs),
                                 torch.from_numpy(qvecs))
    np.testing.assert_array_equal(
        got.numpy(), trank.rank_descriptors(vecs, qvecs, "cpu").numpy())


def test_signed_zero_scores_tie():
    """+0 and -0 scores are one key: the lower index ranks first."""
    vecs = np.array([[0.0, -0.0, 1.0, 0.0]], np.float32)
    got = trank.rank_descriptors(vecs, np.ones((1, 1), np.float32), "cpu")
    want = np.asarray(jrank.rank_descriptors(jnp.asarray(vecs),
                                             jnp.ones((1, 1), jnp.float32)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 0], [2, 0, 1, 3])


@pytest.mark.parametrize("ranks", [[0, 3, 4], [2], [0, 1, 2, 3], [5, 9]])
def test_compute_ap_equals_jax(ranks):
    assert trank.compute_ap(np.asarray(ranks), 4) == \
        jrank.compute_ap(np.asarray(ranks), 4)


@pytest.mark.parametrize("kappas", [(), (1,), (1, 5, 10)])
def test_compute_map_equals_jax(kappas):
    """A plain {ok, junk} gnd with junk and one query without positives."""
    vecs, qvecs = _descriptors()
    ranks = np.asarray(jrank.rank_descriptors(jnp.asarray(vecs),
                                              jnp.asarray(qvecs)))
    gnd = [{"ok": np.concatenate([g["easy"], g["hard"]]), "junk": g["junk"]}
           for g in _gnd(40, 6, empty=4)]
    want = jrank.compute_map(ranks, gnd, kappas)
    got = trank.compute_map(ranks, gnd, kappas)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)     # NaN where no positives
    assert np.isnan(got[1][4])


@pytest.mark.parametrize("empty", [None, 1])
def test_protocols_equal_jax(empty):
    vecs, qvecs = _descriptors(seed=3)
    ranks = trank.rank_descriptors(vecs, qvecs, "cpu").numpy()
    gnd = _gnd(40, 6, seed=4, empty=empty)
    want_m, want_a = jrank.compute_map_protocols("roxford5k", ranks, gnd)
    got_m, got_a = trank.compute_map_protocols("roxford5k", ranks, gnd)
    assert got_m == want_m
    assert sorted(got_m) == ["map_easy", "map_hard", "map_medium"]
    for k in want_a:
        np.testing.assert_array_equal(got_a[k], want_a[k])


def test_plain_gnd_gives_one_map():
    vecs, qvecs = _descriptors(seed=5)
    ranks = trank.rank_descriptors(vecs, qvecs, "cpu").numpy()
    gnd = [{"ok": g["easy"], "junk": g["junk"]} for g in _gnd(40, 6)]
    got_m, got_a = trank.compute_map_protocols("oxford5k", ranks, gnd)
    want_m, want_a = jrank.compute_map_protocols("oxford5k", ranks, gnd)
    assert got_m == want_m and list(got_m) == ["map"]
    np.testing.assert_array_equal(got_a["ap"], want_a["ap"])
