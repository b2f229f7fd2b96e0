"""The port's exact index (gandtr_tpu_torch/serving/index.py) against the
JAX package's `RetrievalIndex` and `exact_topk` on the CPU: names and
scores, the recursive chunked top-k with exact ties across chunk
boundaries (the lower index first, as lax.top_k), shards on one device,
the empty index and k's clamp, and .npz files saved by either package."""
import jax
import numpy as np
import pytest
import torch

from gandtr_tpu.serving.index import RetrievalIndex as JIndex
from gandtr_tpu.serving.index import exact_topk as jax_topk
from gandtr_tpu_torch.serving import load_index
from gandtr_tpu_torch.serving.index import (RetrievalIndex, exact_topk,
                                            key_scores, score_keys)

torch.set_num_threads(2)


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _names(n):
    return ["img%05d" % i for i in range(n)]


def _same(got, want, atol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=atol, rtol=0)


def test_names_and_scores_match_jax():
    """500 x 64 unit rows, k = 9: names equal, scores within 1e-5 (float32
    dot products summed in another order)."""
    rng = np.random.RandomState(0)
    X, q = _unit_rows(rng, 500, 64), _unit_rows(rng, 7, 64)
    j, t = JIndex(64), RetrievalIndex(64, devices=["cpu"])
    j.add(_names(500), X)
    t.add(_names(500), X)
    _same(t.query(q, k=9), j.query(q, k=9))
    assert len(t) == 500


def _tiled(rng, n_base=100, reps=200, d=16):
    """n_base distinct unit rows tiled `reps` times: every score occurs
    `reps` times, 100 columns apart, across the 128-wide chunks."""
    return np.tile(_unit_rows(rng, n_base, d), (reps, 1))


def test_recursive_topk_ties_across_chunks():
    """20,000 x 16 rows with exact ties crossing chunk boundaries: the
    recursive path (n > 4 chunks) gives JAX's indices, the lower first."""
    rng = np.random.RandomState(1)
    X, q = _tiled(rng), _unit_rows(rng, 5, 16)
    s = q @ X.T
    jv, ji = jax_topk(jax.numpy.asarray(s), 9)
    tv, ti = exact_topk(torch.from_numpy(s), 9)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # ties come back in ascending row order: the same base row each time
    assert (np.diff(ti.numpy(), axis=1) > 0).all()
    assert (ti.numpy() % 100 == ti.numpy()[:, :1] % 100).all()
    j, t = JIndex(16), RetrievalIndex(16, devices=["cpu"])
    j.add(_names(len(X)), X)
    t.add(_names(len(X)), X)
    _same(t.query(q, k=9), j.query(q, k=9))


@pytest.mark.parametrize("k", [1, 5, 64])
def test_keys_order_as_score_then_index(k):
    """score_keys / key_scores round-trip float32 bits exactly (negative,
    zero and large values included) and the key order is (score
    descending, index ascending): torch.topk over keys equals a stable
    descending sort."""
    rng = np.random.RandomState(2)
    s = np.round(rng.randn(3, 700) * 3, 1).astype(np.float32)
    s[:, ::7] = 0.0
    s[0, 5] = -1e30
    s[1, 9] = 3e30
    keys = score_keys(torch.from_numpy(s))
    vals, idx = key_scores(keys)
    np.testing.assert_array_equal(vals.numpy(), s)
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(700), (3, 1)))
    v, i = exact_topk(torch.from_numpy(s), k, chunk=16)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(s, order, 1))


def test_four_shards_on_one_device_equal_one():
    """The CPU stands for four devices: four contiguous shards merge to the
    single shard's answer, ties across shards the lower index first."""
    rng = np.random.RandomState(3)
    X, q = _tiled(rng, n_base=50, reps=41, d=16), _unit_rows(rng, 4, 16)
    one = RetrievalIndex(16, devices=["cpu"])
    four = RetrievalIndex(16, devices=["cpu"] * 4)
    for idx in (one, four):
        idx.add(_names(len(X)), X)
    four.build()
    assert [off for off, _ in four._shards] == [0, 512, 1025, 1537]
    _same(four.query(q, k=12), one.query(q, k=12), atol=0)
    j = JIndex(16)
    j.add(_names(len(X)), X)
    _same(four.query(q, k=12), j.query(q, k=12))


def test_empty_index_and_k_clamp():
    rng = np.random.RandomState(4)
    t = RetrievalIndex(8, devices=["cpu"] * 3)
    assert t.query(_unit_rows(rng, 2, 8), k=5) == [[], []]
    X = _unit_rows(rng, 2, 8)
    t.add(["a", "b"], X)       # fewer rows than shards: an empty shard
    got = t.query(X[0], k=10)
    assert len(got) == 1 and len(got[0]) == 2 and got[0][0][0] == "a"
    with pytest.raises(ValueError, match="query dim"):
        t.query(np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="descriptors shape"):
        t.add(["c"], np.zeros((2, 8), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RetrievalIndex(8)


def test_npz_loads_in_either_package(tmp_path):
    """An index saved by either package loads in the other (pickle-free
    keys vecs / names / meta) and answers the same."""
    rng = np.random.RandomState(5)
    X, q = _unit_rows(rng, 300, 32), _unit_rows(rng, 3, 32)
    t = RetrievalIndex(32, devices=["cpu"])
    t.add(_names(300), X)
    t.save(str(tmp_path / "port.npz"))
    j = JIndex(32)
    j.add(_names(300), X)
    j.save(str(tmp_path / "jax.npz"))
    from_jax = load_index(str(tmp_path / "jax"), devices=["cpu"])
    from_port = JIndex.load(str(tmp_path / "port.npz"))
    assert isinstance(from_jax, RetrievalIndex) and len(from_jax) == 300
    _same(from_jax.query(q, k=6), j.query(q, k=6))
    _same(t.query(q, k=6), from_port.query(q, k=6))
    empty = RetrievalIndex(32, devices=["cpu"])
    empty.save(str(tmp_path / "empty.npz"))
    assert len(JIndex.load(str(tmp_path / "empty.npz"))) == 0
