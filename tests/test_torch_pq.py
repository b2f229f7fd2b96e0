"""The port's PQ index (gandtr_tpu_torch/serving/pq.py) against the JAX
package's serving/pq.py on the same seeds, on the CPU: codebooks, the
nearest-centroid assignment, the ADC scan's top-k, rerank against the
exact top-k, the OPQ rotation, the fit-after-add rules and .npz files in
both directions. Held to JAX's outputs, not to the recall bound of
tests/test_pq_index.py's OPQ case."""
import jax
import numpy as np
import pytest
import torch

from gandtr_tpu.serving import pq as jpq
from gandtr_tpu_torch.serving import load_index, pq
from gandtr_tpu_torch.serving.index import RetrievalIndex

torch.set_num_threads(2)
CPU = ["cpu"]


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, n_clusters=32, noise=0.05):
    """tests/test_pq_index.py's data."""
    centers = _unit_rows(rng, n_clusters, d)
    x = centers[rng.randint(0, n_clusters, n)] + noise * rng.randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _names(n):
    return [str(i) for i in range(n)]


def _same(got, want, atol=1e-5):
    for g, w in zip(got, want):
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=atol, rtol=0)


def test_codebooks_match_jax():
    """tests/test_pq_index.py:42's data (2000 x 32, m 4, ksub 16): the same
    initial centroids (one RandomState permutation), 20 Lloyd iterations,
    codebooks within 1e-5."""
    X = _clustered(np.random.RandomState(0), 2000, 32)
    want = jpq.train_product_quantizer(X, m=4, ksub=16, iters=20)
    got = pq.train_product_quantizer(X, m=4, ksub=16, iters=20, device="cpu")
    assert got.shape == (4, 16, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        pq.train_product_quantizer(X, m=5, device="cpu")
    with pytest.raises(ValueError, match="ksub"):
        pq.train_product_quantizer(X, m=4, ksub=300, device="cpu")


def test_assign_codes_equal_jax_given_codebooks():
    rng = np.random.RandomState(1)
    X = _clustered(rng, 3000, 64)
    C = np.array(jpq.train_product_quantizer(X, m=16, ksub=64, iters=5))
    Xs = X.reshape(-1, 16, 4)
    want = np.asarray(jpq._assign(jax.numpy.asarray(C),
                                  jax.numpy.asarray(Xs)))
    got = pq._assign(torch.from_numpy(C), torch.from_numpy(Xs.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    chunked = pq.encode_chunked(torch.from_numpy(C), X, 16, chunk=700)
    np.testing.assert_array_equal(chunked, want)


@pytest.fixture(scope="module")
def scan_case():
    """tests/test_pq_index.py's recall data, the JAX index fitted; the
    port's index on its codebooks."""
    rng = np.random.RandomState(2)
    X = _clustered(rng, 3000, 64, n_clusters=50, noise=0.08)
    q = _clustered(rng, 8, 64, n_clusters=50, noise=0.08)
    j = jpq.PQRetrievalIndex(64, m=16, ksub=64).fit(X, iters=15)
    j.add(_names(3000), X)
    t = pq.PQRetrievalIndex(64, m=16, ksub=64, devices=CPU,
                            codebooks=j.codebooks)
    t.add(_names(3000), X)
    return X, q, j, t


def test_scan_topk_matches_jax(scan_case):
    """The ADC scan (lookup tables, then 16 gathers added in column
    order): the same codes, top-k names equal, scores within 1e-5."""
    X, q, j, t = scan_case
    np.testing.assert_array_equal(t._codes[0], j._codes[0])
    assert t._codes[0].dtype == np.uint8
    _same(t.query(q, k=10), j.query(q, k=10))
    four = pq.PQRetrievalIndex(64, m=16, ksub=64, devices=CPU * 4,
                               codebooks=j.codebooks)
    four.add(_names(3000), X)
    _same(four.query(q, k=10), t.query(q, k=10), atol=0)


def test_rerank_equals_exact_topk():
    """rerank 800 covers the whole index: the answer is the exact top-k,
    names and scores (exact inner products of the host-kept rows)."""
    rng = np.random.RandomState(3)
    X = _clustered(rng, 800, 32, n_clusters=24, noise=0.1)
    q = _clustered(rng, 5, 32, n_clusters=24, noise=0.1)
    exact = RetrievalIndex(32, devices=CPU)
    exact.add(_names(800), X)
    t = pq.PQRetrievalIndex(32, m=8, ksub=64, rerank=800,
                            devices=CPU).fit(X, iters=15)
    t.add(_names(800), X)
    _same(t.query(q, k=5), exact.query(q, k=5))
    j = jpq.PQRetrievalIndex(32, m=8, ksub=64, rerank=800,
                             codebooks=t.codebooks)
    j.add(_names(800), X)
    _same(t.query(q, k=5), j.query(q, k=5))


def test_opq_rotation_orthogonal_and_codes_match_jax():
    """OPQ's rotation is orthogonal; given JAX's rotation and codebooks the
    port's codes equal JAX's and its scores are within 1e-5."""
    rng = np.random.RandomState(4)
    X = _clustered(rng, 1500, 32, n_clusters=40, noise=0.1)
    q = _unit_rows(rng, 4, 32)
    R, C = pq.train_opq_rotation(X, 8, 32, opq_iters=2, kmeans_iters=5,
                                 device="cpu")
    np.testing.assert_allclose(R.T @ R, np.eye(32), atol=1e-5)
    assert C.shape == (8, 32, 4)
    # an assignment that flips on a float32 near-tie moves the next
    # Procrustes step, so the two rotations are compared through JAX's
    Rj, Cj = jpq.train_opq_rotation(X, 8, 32, opq_iters=2, kmeans_iters=5)
    j = jpq.PQRetrievalIndex(32, m=8, ksub=32, codebooks=Cj, rotation=Rj)
    t = pq.PQRetrievalIndex(32, m=8, ksub=32, codebooks=Cj, rotation=Rj,
                            devices=CPU)
    j.add(_names(1500), X)
    t.add(_names(1500), X)
    np.testing.assert_array_equal(t._codes[0], j._codes[0])
    _same(t.query(q, k=7), j.query(q, k=7))
    fitted = pq.PQRetrievalIndex(32, m=8, ksub=32, devices=CPU).fit(
        X, iters=15, opq_iters=2)
    np.testing.assert_allclose(fitted.rotation.T @ fitted.rotation,
                               np.eye(32), atol=1e-5)


def test_fit_after_add_rules():
    rng = np.random.RandomState(5)
    X = _clustered(rng, 400, 16)
    t = pq.PQRetrievalIndex(16, m=4, ksub=16, devices=CPU)
    with pytest.raises(ValueError, match="fit"):
        t.add(_names(10), X[:10])
    t.fit(X, iters=5).add(_names(400), X)
    codes = t._codes[0].copy()
    with pytest.raises(RuntimeError, match="without rerank"):
        t.fit(X, iters=5)
    np.testing.assert_array_equal(t._codes[0], codes)   # left consistent
    r = pq.PQRetrievalIndex(16, m=4, ksub=16, rerank=20, devices=CPU)
    r.fit(X, iters=5).add(_names(400), X)
    r.fit(X[::-1].copy(), iters=7, seed=1)              # re-encodes
    want = pq.encode_chunked(torch.from_numpy(r.codebooks), X, 4)
    np.testing.assert_array_equal(r._codes[0], want.astype(np.uint8))
    j = jpq.PQRetrievalIndex(16, m=4, ksub=16, rerank=20, codebooks=r.codebooks)
    j.add(_names(400), X)
    q = _unit_rows(rng, 3, 16)
    _same(r.query(q, k=4), j.query(q, k=4))
    with pytest.raises(ValueError, match="divisible"):
        pq.PQRetrievalIndex(18, m=4, devices=CPU)


@pytest.mark.parametrize("rerank", [0, 50])
def test_npz_both_ways(tmp_path, rerank):
    rng = np.random.RandomState(6)
    X = _clustered(rng, 200, 32)
    q = _unit_rows(rng, 2, 32)
    t = pq.PQRetrievalIndex(32, m=8, ksub=32, rerank=rerank,
                            devices=CPU).fit(X, iters=10)
    t.add(_names(200), X)
    t.save(str(tmp_path / "port.npz"))
    back = jpq.PQRetrievalIndex.load(str(tmp_path / "port.npz"))
    assert len(back) == 200 and back.rerank == rerank
    _same(back.query(q, k=5), t.query(q, k=5))
    j = jpq.PQRetrievalIndex(32, m=8, ksub=32, rerank=rerank,
                             codebooks=t.codebooks)
    j.add(_names(200), X)
    j.save(str(tmp_path / "jax.npz"))
    mine = load_index(str(tmp_path / "jax.npz"), devices=CPU)
    assert isinstance(mine, pq.PQRetrievalIndex)
    assert len(mine) == 200 and mine.rerank == rerank
    _same(mine.query(q, k=5), j.query(q, k=5))
    if rerank:
        fast = pq.PQRetrievalIndex.load(str(tmp_path / "jax.npz"),
                                        devices=CPU, rerank=0)
        assert fast.rerank == 0 and fast.query(q, k=5)[0]
    else:
        with pytest.raises(ValueError, match="without exact rows"):
            pq.PQRetrievalIndex.load(str(tmp_path / "jax.npz"),
                                     devices=CPU, rerank=10)
