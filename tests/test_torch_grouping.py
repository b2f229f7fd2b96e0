"""The port's grouping layers (gandtr_tpu_torch/models/grouping.py) against
the JAX package's (gandtr_tpu/models/grouping.py) on the CPU.

The same numpy inputs go through both. Values and gradients (jax.grad
against torch autograd, with respect to the features, the attentions and
the codebook) are held to 1e-5 of the larger of 1 and the JAX value's
largest magnitude. The data are clustered so that every feature's k
nearest centroids are apart from the next by more than GAP in float64
(checked on the inputs, before any comparison): a hard assignment is then
the same in both packages and is held equal. The Forgy draws come from
other generators, so clustering is held from the same initial clusters
(`init_clusters_forgy` replaced in both modules by the same draw). The
chunked nearest-centroid search is held bit-equal to the unchunked one.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.models import grouping as J
from gandtr_tpu_torch.models import grouping as P

torch.set_num_threads(1)
TOL = 1e-5
GAP = 1e-3      # float64 distance between the k-th and (k+1)-th centroid


def close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, scale)


def clustered(seed=0, sizes=(20, 16, 12), K=12, D=8, kmax=3):
    """Images of features near seeded centroids, with attentions in
    [0.1, 1]; each feature's kmax nearest centroids clear of the next by
    GAP."""
    rs = np.random.RandomState(seed)
    centroids = (rs.randn(K, D) * 3).astype(np.float32)
    images = []
    for n in sizes:
        f = centroids[rs.randint(K, size=n)] + 0.4 * rs.randn(n, D)
        images.append((f.astype(np.float32),
                       rs.uniform(0.1, 1.0, (n, 1)).astype(np.float32)))
    feats = np.concatenate([f for f, _ in images]).astype(np.float64)
    d = np.sort(np.sqrt(((feats[:, None] - centroids[None].astype(
        np.float64)) ** 2).sum(-1)), axis=1)
    assert (np.diff(d[:, :kmax + 1], axis=1) > GAP).all()
    return images, centroids


def jitted(grouping):
    """The JAX grouping with its assign_images jitted: one compile a call
    signature, where eager JAX compiles every op for every image's shape."""
    grouping.assign_images = jax.jit(grouping.assign_images)
    return grouping


def jimages(images):
    return [(jnp.asarray(f), jnp.asarray(a)) for f, a in images]


def timages(images, grad=False):
    return [(torch.tensor(f, requires_grad=grad),
             torch.tensor(a, requires_grad=grad)) for f, a in images]


# ---- the registries and the mini-DSL

@pytest.mark.parametrize("name", ["SIZE_SHORTCUTS", "FEATURE_FUNCTIONS",
                                  "NEAREST_PARAMS", "ASSIGNMENT_FUNCTIONS",
                                  "DESCRIPTOR_FUNCTIONS", "WEIGHT_FUNCTIONS",
                                  "CLUSTERING_FUNCTIONS", "GROUPINGS"])
def test_registry_keys(name):
    got, want = getattr(P, name), getattr(J, name)
    assert list(got) == list(want)
    if name == "SIZE_SHORTCUTS":
        assert got == want


def test_str_func_call_and_parse_size():
    table = {"f": lambda *a, **k: (a, k)}
    for spec in ("f", "f-3", "f-2.5", "f-3-detach", "F-1-0.5-x-y"):
        assert P.str_func_call(spec, table) == J.str_func_call(spec, table)
    assert P.str_func_call("f-2.5-detach", table) == ((2.5,),
                                                      {"detach": True})
    for size in ("1k", "64k", "512k", 300):
        assert P.parse_size(size) == J.parse_size(size)
    assert P.parse_size("512k") == 524288


def test_cdist_and_idx2rank():
    rs = np.random.RandomState(1)
    a, b = rs.randn(30, 6).astype(np.float32), rs.randn(9, 6).astype(
        np.float32)
    close(P.cdist(torch.tensor(a), torch.tensor(b)), J.cdist(a, b))
    idx = np.stack([rs.permutation(7) for _ in range(5)])
    assert np.array_equal(P.idx2rank_dim1(torch.tensor(idx)).numpy(),
                          np.asarray(J.idx2rank_dim1(jnp.asarray(idx))))


def _grad_pair(jfn, tfn, arrays, seed=2):
    """Values and gradients of sum(out * R) for a JAX and a torch function
    of the same float32 arrays."""
    shape = jax.eval_shape(jfn, *map(jnp.asarray, arrays)).shape
    R = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jout, jg = jax.jit(lambda *xs: (jfn(*xs), jax.grad(
        lambda *ys: jnp.sum(jfn(*ys) * R),
        argnums=tuple(range(len(arrays))))(*xs)))(*map(jnp.asarray, arrays))
    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*targs)
    close(tout, jout)
    loss = (tout * torch.tensor(R)).sum()
    if loss.requires_grad:     # else every JAX gradient must be 0
        loss.backward()
    for t, g in zip(targs, jg):
        close(t.grad if t.grad is not None else torch.zeros_like(t), g)


@pytest.mark.parametrize("key", list(J.FEATURE_FUNCTIONS))
def test_feature_functions(key):
    rs = np.random.RandomState(3)
    x, att = rs.randn(10, 1, 5), rs.uniform(0.1, 1, (10, 1, 1))
    c = rs.randn(4, 5)
    _grad_pair(J.FEATURE_FUNCTIONS[key], P.FEATURE_FUNCTIONS[key],
               [a.astype(np.float32) for a in (x, att, c)])


@pytest.mark.parametrize("spec", ["uniform", "softmax-2.5",
                                  "softmax-2.5-detach", "softmax2-0.5",
                                  "rankserie-2", "cmeans-2", "cmeans-1.5"])
def test_assignment_functions(spec):
    rs = np.random.RandomState(4)
    dst = rs.uniform(0.2, 3.0, (9, 6)).astype(np.float32)
    _grad_pair(J.str_func_call(spec, J.ASSIGNMENT_FUNCTIONS),
               P.str_func_call(spec, P.ASSIGNMENT_FUNCTIONS), [dst])


@pytest.mark.parametrize("spec", ["l2norm", "normsign", "sigmoid-3",
                                  "sigmoid-0.5"])
def test_descriptor_functions(spec):
    d = np.random.RandomState(5).randn(6, 7).astype(np.float32)
    _grad_pair(J.str_func_call(spec, J.DESCRIPTOR_FUNCTIONS),
               P.str_func_call(spec, P.DESCRIPTOR_FUNCTIONS), [d])


def test_l2norm_descriptor_of_a_centroid_without_features():
    """A zero row (a centroid no feature chose) is 0 in both packages. Its
    gradient is JAX's norm's NaN (sqrt at 0) and the port's finite one;
    neither reaches a feature or the codebook, since the hard path's sum
    per centroid sends a row's gradient only to the features assigned to
    it (test_assign_images_values_and_gradients holds those)."""
    d = np.random.RandomState(5).randn(6, 7).astype(np.float32)
    d[2] = 0.0
    jf = J.str_func_call("l2norm", J.DESCRIPTOR_FUNCTIONS)
    tf = P.str_func_call("l2norm", P.DESCRIPTOR_FUNCTIONS)
    t = torch.tensor(d, requires_grad=True)
    out = tf(t)
    close(out, jf(jnp.asarray(d)))
    assert not out[2].any()
    out.sum().backward()
    jg = np.asarray(jax.grad(lambda x: jf(x).sum())(jnp.asarray(d)))
    assert np.isnan(jg[2]).all() and np.isfinite(jg[[0, 1, 3, 4, 5]]).all()
    assert torch.isfinite(t.grad).all()
    close(t.grad[[0, 1, 3, 4, 5]], jg[[0, 1, 3, 4, 5]])


@pytest.mark.parametrize("spec", ["unif", "maxass", "avgass", "maxassatt",
                                  "maxassatt-detach", "softmaxassatt",
                                  "avgassatt", "avgassatt-detach",
                                  "avgassatt2", "descnorm3"])
def test_weight_functions(spec):
    rs = np.random.RandomState(6)
    d, f = rs.randn(5, 4).astype(np.float32), rs.randn(8, 5, 4)
    att = rs.uniform(0.1, 1, (8, 1)).astype(np.float32)
    ass = rs.uniform(0, 1, (8, 5)).astype(np.float32)
    ass[ass < 0.3] = 0.0
    jw = J.str_func_call(spec, J.WEIGHT_FUNCTIONS)
    tw = P.str_func_call(spec, P.WEIGHT_FUNCTIONS)
    _grad_pair(lambda d_, a_, s_: jw(d_, f, a_, s_),
               lambda d_, a_, s_: tw(d_, torch.tensor(f), a_, s_),
               [d, att, ass])


@pytest.mark.parametrize("spec", ["all", "top", "top-3"])
def test_nearest_params(spec):
    assert P.str_func_call(spec, P.NEAREST_PARAMS) == \
        J.str_func_call(spec, J.NEAREST_PARAMS)


# ---- assignment

HARD = [("res", "top", "uniform", "l2norm", "maxass"),
        ("normresatt", "top-3", "softmax-2.0", "l2norm", "avgassatt"),
        ("resatt", "top-2", "rankserie-2", "sigmoid-2.0", "softmaxassatt"),
        ("iden", "top", "uniform", "normsign", "unif")]
SOFT = [("res", "all", "softmax-3.0", "l2norm", "avgass"),
        ("normressoftmaxatt", "all", "cmeans-2", "l2norm", "maxassatt"),
        ("att", "all", "softmax2-1.0", "sigmoid-1.5", "avgassatt2"),
        ("normresatt2", "all", "uniform", "l2norm", "descnorm3")]


@pytest.mark.parametrize("cfg", HARD + SOFT, ids=lambda c: "-".join(c))
def test_assign_features(cfg):
    images, centroids = clustered()
    f, a = images[0]
    got = P.Grouping(12, *cfg).assign_features(
        torch.tensor(f), torch.tensor(a), torch.tensor(centroids))
    want = jax.jit(J.Grouping(12, *cfg).assign_features)(
        jnp.asarray(f), jnp.asarray(a), jnp.asarray(centroids))
    for g, w in zip(got, want):
        close(g, w)
    if cfg in HARD:      # the same centroids chosen
        assert np.array_equal(got[2].detach().numpy() != 0,
                              np.asarray(want[2]) != 0)


@pytest.mark.parametrize("cfg", HARD + SOFT, ids=lambda c: "-".join(c))
def test_assign_images_values_and_gradients(cfg):
    """Three images, the last one empty: descriptors, weights, and the
    gradients of a random projection of both with respect to every
    feature, attention and the codebook."""
    images, centroids = clustered(sizes=(20, 16, 0))
    rs = np.random.RandomState(7)
    R = rs.randn(3, 12, 8).astype(np.float32)
    r = rs.randn(3, 12).astype(np.float32)

    def jloss(feats, atts, c):
        d, w = J.Grouping(12, *cfg).assign_images(list(zip(feats, atts)), c)
        return jnp.sum(d * R) + jnp.sum(w * r), (d, w)

    jf = [jnp.asarray(f) for f, _ in images]
    ja = [jnp.asarray(a) for _, a in images]
    (_, (jd, jw)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jf, ja, jnp.asarray(centroids))
    ti = timages(images, grad=True)
    tc = torch.tensor(centroids, requires_grad=True)
    td, tw = P.Grouping(12, *cfg).assign_images(ti, tc)
    close(td, jd)
    close(tw, jw)
    ((td * torch.tensor(R)).sum() + (tw * torch.tensor(r)).sum()).backward()
    for t, g in zip([f for f, _ in ti] + [a for _, a in ti] + [tc],
                    list(jg[0]) + list(jg[1]) + [jg[2]]):
        close(t.grad if t.grad is not None else torch.zeros_like(t), g)


def test_empty_image_contributes_the_descriptor_of_zeros():
    images, centroids = clustered(sizes=(0, 5))
    for cfg in (HARD[0], ("res", "top", "uniform", "sigmoid-2.0", "maxass")):
        td, tw = P.Grouping(12, *cfg).assign_images(
            timages(images), torch.tensor(centroids))
        jd, jw = jitted(J.Grouping(12, *cfg)).assign_images(
            jimages(images), jnp.asarray(centroids))
        close(td, jd)
        close(tw, jw)
        assert not tw[0].any()


def test_soft_path_refuses_past_its_limit(monkeypatch):
    images, centroids = clustered()
    g = P.Grouping(12, *SOFT[0])
    f, a = timages(images)[0]
    monkeypatch.setattr(P, "SOFT_MAX_ELEMENTS", f.shape[0] * 12 * 8 - 1)
    with pytest.raises(ValueError, match="SOFT_MAX_ELEMENTS"):
        g.assign_features(f, a, torch.tensor(centroids))


# ---- the chunked nearest-centroid search

@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("shape", [(64, 600, 16), (50, 800, 12), (7, 300, 3)])
def test_nearest_chunked_bit_equal_to_unchunked(k, shape):
    n, K, D = shape
    rs = np.random.RandomState(8)
    a = torch.tensor(rs.randn(n, D).astype(np.float32))
    b = torch.tensor(rs.randn(K, D).astype(np.float32))
    b[290] = b[9]                    # an exact tie: the lower index wins
    want = P.nearest(a, b, k, chunk=K)
    for chunk in (1, P.GEMM_ROWS, 2 * P.GEMM_ROWS):
        got = P.nearest(a, b, k, chunk=chunk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool((want[1] == 290).any())
    jv, ji = jax.jit(lambda x, y: jax.lax.top_k(-J.cdist(x, y), k))(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    gaps = np.diff(np.sort(np.asarray(-jv), 1), axis=1)
    assert np.array_equal(want[1].numpy(), np.asarray(ji)) or \
        not (np.abs(gaps) >= GAP).all()
    close(want[0], -jv)


SMALL_CHUNKS = P.GEMM_ROWS * 16 * 50   # GEMM_ROWS-wide chunks, rows by 50


def test_hard_path_and_kmeans_chunked_bit_equal(monkeypatch):
    """The hard path and k-means with the codebook in GEMM_ROWS-wide
    chunks and the features in blocks of 50 (a small CHUNK_BYTES), bit for
    bit as in one chunk (the same on this BLAS)."""
    images, centroids = clustered(sizes=(40, 30, 20), K=600)
    g = P.Grouping(600, *HARD[1])
    pts = torch.tensor(np.random.RandomState(15).randn(700, 8).astype(
        np.float32))
    init = pts[:400]

    def run():
        return (g.assign_images(timages(images), torch.tensor(centroids)),
                P.nearest(pts, init), P.iterate_kmeans(pts, init, 3))
    whole = run()
    monkeypatch.setattr(P, "CHUNK_BYTES", SMALL_CHUNKS)
    assert P.chunk_columns(700) == P.GEMM_ROWS
    chunked = run()
    for a, b in zip(whole[0] + whole[1] + (whole[2],),
                    chunked[0] + chunked[1] + (chunked[2],)):
        assert torch.equal(a, b)


# ---- clustering

def _points(seed=9, n=60, D=4):
    rs = np.random.RandomState(seed)
    centers = rs.randn(5, D) * 4
    return (centers[rs.randint(5, size=n)] + 0.5 * rs.randn(n, D)).astype(
        np.float32)


@pytest.mark.parametrize("spec", ["kmeans", "cmeans-2", "cmeans-1.5",
                                  "softmax-10", "softmax-1.5"])
def test_clustering_iterations_from_given_clusters(spec):
    pts = _points()
    init = pts[[0, 7, 13, 21, 34, 40]].copy()
    if spec == "kmeans":
        init[5] = 100.0           # no point ever chooses it: it stays
    got = P.str_func_call(spec, P.CLUSTERING_FUNCTIONS)(
        torch.tensor(pts), torch.tensor(init), 4)
    want = J.str_func_call(spec, J.CLUSTERING_FUNCTIONS)(
        jnp.asarray(pts), jnp.asarray(init), 4)
    close(got, want)
    if spec == "kmeans":
        assert (got[5] == 100.0).all()


@pytest.fixture
def forgy(monkeypatch):
    """Both packages' init_clusters_forgy replaced by the same draws: the
    i-th call takes DRAWS[i]'s rows."""
    draws = [[0, 5, 11, 17, 23], [3, 8, 30, 41, 50], [1, 2, 3, 4, 5]]

    def fake(count):
        def init(points, n_clusters, _rng):
            idx = draws[count[0]][:n_clusters]
            count[0] += 1
            return points[np.asarray(idx)]
        return init
    monkeypatch.setattr(J, "init_clusters_forgy", fake([0]))
    monkeypatch.setattr(P, "init_clusters_forgy", fake([0]))
    return draws


@pytest.mark.parametrize("clustering", ["kmeans", "softmax-10"])
def test_batch_clustering_with_injected_draws(forgy, clustering):
    """Each batch's clusters (from the batch's draw) against JAX's, and the
    descriptors and weights against JAX's assignment on the port's
    clusters: a residual summed over a cluster's features moves with the
    float32 rounding of its cluster times the feature count, so the two
    are held apart."""
    pts = _points()
    images = [(pts[:35], np.full((35, 1), 0.5, np.float32)),
              (pts[35:], np.linspace(0.1, 1, 25, dtype=np.float32)[:, None])]
    cfg = ("res", "top", "uniform", "l2norm", "maxass", clustering, 3)
    jb = jitted(J.BatchClustering(5, *cfg, outputdim=4))
    tb = P.BatchClustering(5, *cfg, outputdim=4)
    seen = {"j": [], "t": []}
    j_assign, t_assign = jb.assign_images, tb.assign_images
    jb.assign_images = lambda im, c: seen["j"].append(c) or j_assign(im, c)
    tb.assign_images = lambda im, c: seen["t"].append(c) or t_assign(im, c)
    for i in range(2):       # the second batch takes the second draw
        td, tw = tb(images)
        jb._forward(jimages(images))
        close(seen["t"][i], seen["j"][i])
        jd, jw = jitted(J.Grouping(5, *cfg[:5])).assign_images(
            jimages(images), jnp.asarray(seen["t"][i].numpy()))
        close(td, jd)
        close(tw, jw)
    assert not np.array_equal(seen["t"][0], seen["t"][1])


def test_batch_clustering_draws_fresh_clusters_per_batch():
    pts = torch.tensor(_points(n=200))
    b = P.BatchClustering(5, "res", "top", "uniform", "l2norm", "maxass",
                          "kmeans", 0, outputdim=4, seed=3)
    images = [(pts, torch.ones(200, 1))]
    first, second = b(images)[0], b(images)[0]
    assert not torch.equal(first, second)
    again = P.BatchClustering(5, "res", "top", "uniform", "l2norm", "maxass",
                              "kmeans", 0, outputdim=4, seed=3)
    assert torch.equal(again(images)[0], first)
    assert b.generator.device == pts.device


@pytest.mark.parametrize("label,iterations", [("ClusteringCodebook", 4),
                                              ("FaissCodebook", None)])
def test_compute_codebook_with_injected_draws(forgy, label, iterations):
    pts = _points(n=60)
    kw = {} if iterations is None else {"iterations": iterations}
    args = (5, "res", "top", "uniform", "sigmoid-1.0", "maxass")
    tc = P.GROUPINGS[label](*args, outputdim=4, **kw)
    jc = jitted(J.GROUPINGS[label](*args, outputdim=4, **kw))
    assert tc.params["iterations"] == jc.params["iterations"]
    tc.compute_codebook(torch.tensor(pts))
    jc.compute_codebook(jnp.asarray(pts))
    assert isinstance(tc.codebook, torch.nn.Parameter)
    close(tc.codebook, jc.codebook)
    images = [(pts[:30], np.ones((30, 1), np.float32))]
    got, want = tc(images), jc._forward(jimages(images))
    close(got[0], want[0])
    close(got[1], want[1])


# ---- codebooks and top-centroid reduction

@pytest.mark.parametrize("cfg,top", [
    (("res", "top", "uniform", "l2norm", "maxass"), 5),
    (("normresatt", "top", "uniform", "l2norm", "avgassatt"), 4),
    (("res", "top", "uniform", "l2norm", "maxassatt"), 20),
    (("res", "all", "softmax-2.0", "l2norm", "avgass"), 5),
    (("resatt", "all", "softmax-4.0", "l2norm", "maxassatt"), 3)],
    ids=lambda c: "-".join(c) if isinstance(c, tuple) else str(c))
def test_codebook_top_centroids(cfg, top, monkeypatch):
    images, centroids = clustered(sizes=(20, 16, 12))
    tc = P.Codebook(centroids, *cfg, top_centroids=top)
    jc = jitted(J.Codebook(centroids, *cfg, top_centroids=top))
    got, want = tc(images), jc._forward(jimages(images))
    close(got[0], want[0])
    close(got[1], want[1])
    assert got[0].shape[1] == min(top, got[0].shape[1])
    if cfg[1] == "top":
        monkeypatch.setattr(P, "CHUNK_BYTES", SMALL_CHUNKS)
        again = tc(images)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1],
                                                             got[1])


def test_codebook_top_centroids_gradients():
    """The reduced hard path's gradients into the features and the
    codebook parameter against the same assignment in JAX on the reduced
    codebook and filtered features (JAX's reduction runs on the host, so
    jax.grad cannot trace it)."""
    images, centroids = clustered(sizes=(20, 16, 12, 9))
    cfg = ("res", "top", "uniform", "l2norm", "avgassatt")
    tc = P.Codebook(centroids, *cfg, top_centroids=5)
    ti = timages(images, grad=True)
    codebook, reduced = tc.reduce(ti)
    td, tw = tc.assign_images(reduced, codebook)
    R = np.random.RandomState(10).randn(*td.shape).astype(np.float32)
    ((td * torch.tensor(R)).sum() + tw.sum()).backward()
    jc = J.Codebook(centroids, *cfg, top_centroids=5)
    feats = np.concatenate([f for f, _ in images])
    idx = np.argmin(np.asarray(J.cdist(feats, centroids)), axis=1)
    atts = np.concatenate([a for _, a in images[:2]])
    w = np.asarray(jc.weight_function(None, None, atts, np.eye(12)[
        idx[:atts.shape[0]]].astype(np.float32)))
    keep, mask = J.Codebook._reduce_codebook(w, idx, np.arange(12), 5)
    filtered = J.Codebook._filter_features(jimages(images), mask)

    def jloss(c):
        d, wj = jc.assign_images(filtered, c[keep])
        return jnp.sum(d * R) + jnp.sum(wj)
    close(tc.codebook.grad, jax.jit(jax.grad(jloss))(jnp.asarray(centroids)))
    jfg = jax.jit(jax.grad(lambda fs: jnp.sum(jc.assign_images(
        [(f, a) for f, (_, a) in zip(fs, filtered)],
        jnp.asarray(centroids)[keep])[0] * R)))(
        [f for f, _ in filtered])
    for (f, _), g, m in zip(ti, jfg, _split_mask(mask, images)):
        want = np.zeros(f.shape, np.float32)
        want[np.nonzero(m)[0]] = np.asarray(g)
        close(f.grad, want)


def _split_mask(mask, images):
    out, p = [], 0
    for f, _ in images:
        out.append(mask[p:p + f.shape[0]])
        p += f.shape[0]
    return out


@pytest.mark.parametrize("case", range(3))
def test_reduce_codebook_and_filter_features(case):
    rs = np.random.RandomState(11 + case)
    w = rs.choice([0.0, 0.5, 1.0, 2.0], size=20).astype(np.float32)
    idx = rs.randint(20, size=30)
    cb = rs.randn(20, 3).astype(np.float32)
    top = (4, 30, 7)[case]
    got = P.Codebook._reduce_codebook(w, idx, cb, top)
    want = J.Codebook._reduce_codebook(w, idx, cb, top)
    assert np.array_equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        assert np.array_equal(got[1], want[1])
        imgs = [(rs.randn(n, 3).astype(np.float32),
                 rs.rand(n, 1).astype(np.float32)) for n in (10, 0, 20)]
        tf = P.Codebook._filter_features(timages(imgs), got[1])
        jf = J.Codebook._filter_features(jimages(imgs), want[1])
        for (a, b), (c, d) in zip(tf, jf):
            assert np.array_equal(a.numpy(), np.asarray(c))
            assert np.array_equal(b.numpy(), np.asarray(d))


def test_loaded_codebook_from_the_same_pickle(tmp_path):
    images, centroids = clustered()
    path = str(tmp_path / "codebook.pkl")
    with open(path, "wb") as handle:
        pickle.dump({"state": {"centroids": centroids}}, handle)
    cfg = ("res", "top", "uniform", "l2norm", "maxass")
    tc = P.LoadedCodebook(path, *cfg, outputdim=8)
    jc = jitted(J.LoadedCodebook(path, *cfg, outputdim=8))
    assert np.array_equal(tc.codebook.detach().numpy(),
                          np.asarray(jc.codebook))
    assert list(tc.state_dict()) == ["codebook"]
    got, want = tc(images), jc._forward(jimages(images))
    close(got[0], want[0])
    close(got[1], want[1])
    assert np.array_equal(P.LoadedCodebook.load_codebook(centroids).numpy(),
                          centroids)
    with pytest.raises(NotImplementedError, match="only local files"):
        P.LoadedCodebook("https://example.org/c.pkl", *cfg)


def test_codebook_refuses_what_jax_asserts():
    cb = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="weight function"):
        P.Codebook(cb, "res", "top", "uniform", "l2norm", "descnorm3",
                   top_centroids=2)
    with pytest.raises(NotImplementedError, match="top-2"):
        P.Codebook(cb, "res", "top-2", "uniform", "l2norm", "maxass",
                   top_centroids=2)([(np.ones((3, 2), np.float32),
                                      np.ones((3, 1), np.float32))] * 2)
    with pytest.raises(ValueError, match="positive"):
        P.Grouping(0, "res", "top", "uniform", "l2norm", "maxass")
