"""Local-feature grouping layers of the VLAD family (counterpart of
gandtr_tpu/models/grouping.py; the reference's layers/{grouping,
functional}.py).

String-configured feature / assignment / descriptor / weight functions
(the `func-arg1-arg2-flag` mini-DSL of `str_func_call`), hard (top-k
nearest, summed per centroid) and soft assignment, per-batch clustering
(k-means, fuzzy c-means, softmax k-means from Forgy draws) and codebooks
of up to 512k centroids with top-centroid reduction.

Shapes: features (N, D), attentions (N, 1), centroids (K, D); an image is
a (features, attentions) pair. The hard path returns the dense (K, D)
descriptor and the dense (N, K) assignment, as the JAX package does.

Where the port differs in form, not in result:

- The hard path's distances and top-k (and k-means' argmin) run over the
  codebook in chunks (`nearest`), keeping a running top-k in JAX's tie
  order (`lax.top_k` and `argmin`: the lower index first). The squared
  norms are computed once for all rows, and every matrix product takes
  `GEMM_ROWS` codebook rows (the last block padded with zero rows): a BLAS
  or cuBLAS picks its algorithm, and with it the summation order, by the
  product's shape, and would move a distance by an ulp. So the result
  does not depend on the chunk; one chunk of the whole codebook is the
  unchunked search, bit for bit. A chunk's temporaries take about
  `CHUNK_BYTES` at most, whatever the feature count (features go in
  blocks past that).
- The sums per centroid (JAX's `segment_sum`) and the gradient of the
  centroid gather add in an order fixed by the data, so two runs agree
  bit for bit: on CUDA by `index_put_(accumulate=True)` (advanced
  indexing's backward), which runs sorted by index with no atomics
  (`index_add_` adds with atomics there); on the CPU by `index_add_`
  (`index_select`'s backward), which adds in order (`index_put_` adds
  with atomics on several threads there).
- The soft path keeps JAX's (N, K, D) form and refuses a feature tensor
  past `SOFT_MAX_ELEMENTS` elements rather than running out of memory.
- A codebook is an `nn.Module` holding it as an `nn.Parameter` (the JAX
  codebook is an array held by the caller). Forgy draws come from a
  `torch.Generator` on the points' device, so they differ from JAX's
  `jax.random.permutation`; `init_clusters_forgy` is the one place they
  are made.
- `FaissCodebook.compute_codebook` runs the exact k-means (Forgy and
  `niter` Lloyd iterations), which is the JAX package's path without
  faiss; the port does not try to import faiss.
- `LoadedCodebook` reads a local pickle only; a URL raises.
"""
import pickle

import numpy as np
import torch
from torch import nn

from gandtr_tpu_torch.parallel import spatial

SIZE_SHORTCUTS = {"1k": 1024, "2k": 2048, "4k": 4096, "8k": 8192, "16k": 16384,
                  "32k": 32768, "64k": 65536, "128k": 131072, "256k": 262144,
                  "512k": 524288}

EPS = 1e-6
#: the most bytes the temporaries of one chunk of `nearest` may take
#: (its float32 distance block and what makes it)
CHUNK_BYTES = 1 << 30
#: the codebook rows of every matrix product of `nearest`
GEMM_ROWS = 256
#: the soft path's (N, K, D) feature tensor past which it refuses (8 GiB
#: in float32)
SOFT_MAX_ELEMENTS = 1 << 31


def parse_size(size):
    if isinstance(size, str):
        return SIZE_SHORTCUTS[size]
    return size


def _norm(v, dim):
    return torch.linalg.vector_norm(v, dim=dim, keepdim=True)


def normalize_vec_l2(v):
    return v / (_norm(v, -1) + EPS)


def _squared_norms(a):
    return (a ** 2).sum(-1)


def _distances(a2, b2, ab):
    """sqrt(max(a2 + b2 - 2 ab, 0)) for ab (len(a2), len(b2)), JAX's
    expanded-square form."""
    sq = a2[:, None] + b2[None, :] - 2.0 * ab
    return torch.sqrt(torch.clamp(sq, min=0.0))


def cdist(a, b):
    """Euclidean distances (N, K) in JAX's expanded-square form (not
    `torch.cdist`, whose rounding differs near ties)."""
    return _distances(_squared_norms(a), _squared_norms(b), a @ b.T)


def _bytes_per_element(k):
    """Temporaries of `nearest` an element of a chunk's distance block: the
    products, the sums and the distances (and the sort's values and
    indexes for k > 1)."""
    return 16 if k == 1 else 32


def chunk_columns(n_rows, k=1):
    """Codebook rows a chunk of `nearest` takes for `n_rows` features: a
    multiple of GEMM_ROWS whose temporaries fit CHUNK_BYTES (one
    GEMM_ROWS-wide product at least)."""
    per_column = n_rows * _bytes_per_element(k)
    return max(1, CHUNK_BYTES // max(per_column, 1) // GEMM_ROWS) * GEMM_ROWS


def nearest(features, centroids, k=1, chunk=None):
    """(distances (N, k), indexes (N, k)) of the k nearest centroids of
    each feature, nearest first and the lower index first on a tie (JAX's
    `lax.top_k(-cdist(...), k)`), merged over `chunk` centroids at a time
    (`chunk_columns` by default, rounded up to a multiple of GEMM_ROWS);
    more than CHUNK_BYTES // (GEMM_ROWS * bytes an element) features go in
    blocks of that many. Takes no gradient."""
    with torch.no_grad():
        n, n_centroids = features.shape[0], centroids.shape[0]
        if k > n_centroids:
            raise ValueError("top-%d of %d centroids" % (k, n_centroids))
        rows = max(1, CHUNK_BYTES // (GEMM_ROWS * _bytes_per_element(k)))
        chunk = -(-int(chunk or chunk_columns(min(n, rows), k))
                  // GEMM_ROWS) * GEMM_ROWS
        b2 = _squared_norms(centroids)
        out = [_nearest_rows(features[r:r + rows], centroids, b2, k, chunk)
               for r in range(0, n, rows)]
        return (torch.cat([d for d, _ in out]),
                torch.cat([i for _, i in out]))


def _nearest_rows(features, centroids, b2, k, chunk):
    """`nearest` for one block of features."""
    n, n_centroids = features.shape[0], centroids.shape[0]
    a2 = _squared_norms(features)
    buf = features.new_empty((min(chunk, -(-n_centroids // GEMM_ROWS)
                                  * GEMM_ROWS), n))
    best_d = best_i = None
    for s in range(0, n_centroids, chunk):
        width = min(chunk, n_centroids - s)
        # (width, n): a centroid a row, its distance to every feature
        for j in range(0, width, GEMM_ROWS):
            block = centroids[s + j:s + min(j + GEMM_ROWS, width)]
            if block.shape[0] < GEMM_ROWS:
                block = torch.cat([block, block.new_zeros(
                    (GEMM_ROWS - block.shape[0],) + tuple(block.shape[1:]))])
            torch.mm(block, features.T, out=buf[j:j + GEMM_ROWS])
        d = _distances(b2[s:s + width], a2, buf[:width])
        if k == 1:
            i = d.argmin(dim=0)
            v = d.gather(0, i[None])[0]
            i = i + s
            if best_d is None:
                best_d, best_i = v, i
            else:
                # strictly better only: a tie keeps the earlier chunk's
                # lower index
                better = v < best_d
                best_d = torch.where(better, v, best_d)
                best_i = torch.where(better, i, best_i)
            continue
        v, i = torch.sort(d, dim=0, stable=True)
        v, i = v[:k].T, i[:k].T + s
        if best_d is not None:
            # the running entries come first and hold lower indexes, so a
            # stable sort keeps JAX's order on ties
            v, order = torch.sort(torch.cat([best_d, v], 1), dim=1,
                                  stable=True)
            i = torch.cat([best_i, i], 1).gather(1, order)
            v, i = v[:, :k], i[:, :k]
        best_d, best_i = v, i
        del d
    if k == 1:
        return best_d[:, None], best_i[:, None]
    return best_d, best_i


def _segment_sum(values, index, n_segments):
    """JAX's segment_sum of rows: (n_segments, ...) sums, in an order fixed
    by the data on either device."""
    out = values.new_zeros((n_segments,) + tuple(values.shape[1:]))
    if values.is_cuda:
        return out.index_put((index,), values, accumulate=True)
    return out.index_add(0, index, values)


def _gather_rows(table, index):
    """table[index], its backward in an order fixed by the data on either
    device."""
    if table.is_cuda:
        return table[index]
    return table.index_select(0, index.reshape(-1)).reshape(
        tuple(index.shape) + tuple(table.shape[1:]))


def idx2rank_dim1(idxs):
    """Indexes -> ranks across dim 1 (functional.py:12-18)."""
    n, k = idxs.shape
    ranks = torch.empty_like(idxs)
    return ranks.scatter(1, idxs, torch.arange(k, device=idxs.device)
                         .expand(n, k).contiguous())


def assign_weights_softmax(dists, base):
    return torch.softmax(-base * dists, dim=1)


def assign_weights_cmeans(dists, fuzzifier, eps=EPS):
    dists_eps = eps ** ((fuzzifier - 1) / 2)
    d = dists + dists_eps
    ratio = d[:, :, None] / d[:, None, :]
    return 1.0 / (ratio ** (2.0 / (fuzzifier - 1))).sum(-1)


FEATURE_FUNCTIONS = {
    "iden": lambda x, att, c: x,
    "att": lambda x, att, c: att * x,
    "res": lambda x, att, c: x - c,
    "resatt": lambda x, att, c: att * (x - c),
    "normres": lambda x, att, c: normalize_vec_l2(x - c),
    "normresatt": lambda x, att, c: att * normalize_vec_l2(x - c),
    "normressoftmaxatt": lambda x, att, c: (
        torch.softmax(att, dim=0) * att * normalize_vec_l2(x - c)),
    "normresatt2": lambda x, att, c: att ** 2 * normalize_vec_l2(x - c),
}

NEAREST_PARAMS = {
    "all": lambda: None,
    "top": lambda ma=1: ma,
}


def _detached(x, detach):
    return x.detach() if detach else x


ASSIGNMENT_FUNCTIONS = {
    "uniform": lambda: (lambda dst: torch.ones_like(dst)),
    "softmax": lambda base, *, detach=False: (
        lambda dst: assign_weights_softmax(_detached(dst, detach), base)),
    "softmax2": lambda base: (lambda dst: assign_weights_softmax(dst ** 2,
                                                                  base)),
    "rankserie": lambda base: (lambda dst: base ** (
        -idx2rank_dim1(torch.argsort(dst, dim=1, stable=True))
        .to(dst.dtype) - 1) * (base - 1)),
    "cmeans": lambda fuzzifier: (
        lambda dst: assign_weights_cmeans(dst, fuzzifier)),
}

DESCRIPTOR_FUNCTIONS = {
    "l2norm": lambda: (lambda d: d / (_norm(d, 1) + EPS)),
    "normsign": lambda: (lambda d: torch.sign(d) / d.shape[1] ** 0.5),
    "sigmoid": lambda base: (lambda d: 2 * torch.sigmoid(base * d) - 1),
}

# every weight function reduces over the features (dim 0) column by column;
# `amax` shares a tie's gradient equally, as JAX's max does
WEIGHT_FUNCTIONS = {
    "unif": lambda: (lambda d, f, att, ass: (ass != 0).any(dim=0)
                     .to(ass.dtype)),
    "maxass": lambda: (lambda d, f, att, ass: ass.amax(dim=0)),
    "avgass": lambda: (lambda d, f, att, ass: ass.mean(dim=0)),
    "maxassatt": lambda *, detach=False: (lambda d, f, att, ass: _detached(
        ass * att, detach).amax(dim=0)),
    "softmaxassatt": lambda: (lambda d, f, att, ass: (
        torch.softmax(ass * att, dim=0) * ass * att).sum(dim=0)),
    "avgassatt": lambda *, detach=False: (lambda d, f, att, ass: _detached(
        ass * att, detach).mean(dim=0)),
    "avgassatt2": lambda: (lambda d, f, att, ass: (ass * att ** 2)
                           .mean(dim=0)),
    "descnorm3": lambda: (lambda d, f, att, ass: torch.linalg.vector_norm(
        d, dim=-1) ** 3),
}


def str_func_call(func, functions):
    """`func-arg1-arg2-flag` -> functions[func](arg1, arg2, flag=True)
    (grouping.py:126-139): a number is an argument (a float when it has a
    `.`), any other string a flag."""
    name, *params = func.lower().split("-")
    args, kwargs = [], {}
    for param in params:
        try:
            args.append(float(param) if "." in param else int(param))
        except ValueError:
            kwargs[param] = True
    return functions[name](*args, **kwargs)


class Grouping(nn.Module):
    """Composable grouping (grouping.py:19-171). `forward(images)` takes a
    list of (features (N, D), attentions (N, 1)) per image and returns
    (descriptors (n_images, K, D), weights (n_images, K))."""

    def __init__(self, centroids, features, nearest, assignment, descriptor,
                 weights):
        super().__init__()
        centroids = parse_size(centroids)
        if not centroids > 0:
            raise ValueError("centroids must be positive, got %r"
                             % (centroids,))
        self.feature_function = FEATURE_FUNCTIONS[features.lower()]
        self.nearest = str_func_call(nearest, NEAREST_PARAMS)
        self.assignment_function = str_func_call(assignment,
                                                 ASSIGNMENT_FUNCTIONS)
        self.weight_function = str_func_call(weights, WEIGHT_FUNCTIONS)
        self.descriptor_function = str_func_call(descriptor,
                                                 DESCRIPTOR_FUNCTIONS)
        self.params = {"centroids": centroids, "features": features,
                       "nearest": nearest, "assignment": assignment,
                       "descriptor": descriptor, "weights": weights}

    def assign_features(self, features, attentions, centroids):
        """(descriptor (K, D), expanded features, dense assignment (N, K))."""
        n, dim = features.shape
        n_centroids = centroids.shape[0]
        if self.nearest is None:
            if n * n_centroids * dim > SOFT_MAX_ELEMENTS:
                raise ValueError(
                    "soft assignment of %d features to %d centroids of %d "
                    "dimensions makes a %d-element tensor, past the soft "
                    "path's limit of %d (SOFT_MAX_ELEMENTS)"
                    % (n, n_centroids, dim, n * n_centroids * dim,
                       SOFT_MAX_ELEMENTS))
            assignment = self.assignment_function(cdist(features, centroids))
            f = self.feature_function(features[:, None, :],
                                      attentions[:, None, :], centroids)
            return (f * assignment[:, :, None]).sum(0), f, assignment

        # hard: top-k nearest, summed per centroid
        k = self.nearest
        dists, indexes = nearest(features.detach(), centroids.detach(), k)
        assignment = self.assignment_function(dists)
        f = self.feature_function(features[:, None, :],
                                  attentions[:, None, :],
                                  _gather_rows(centroids, indexes))
        weighted = f * assignment[:, :, None]  # (N, k, D)
        descriptor = _segment_sum(weighted.reshape(-1, dim),
                                  indexes.reshape(-1), n_centroids)
        rows = torch.arange(n, device=features.device)[:, None].expand(n, k)
        dense = assignment.new_zeros((n, n_centroids)).index_put(
            (rows, indexes), assignment)
        return descriptor, f, dense

    def assign_images(self, images, centroids):
        grouped, weights = [], []
        zeros = None
        for feat, att in images:
            if feat.shape[0] == 0:
                # reference guard (grouping.py:98): an image whose features
                # were all filtered out contributes zero rows
                if zeros is None:
                    zeros = (self.descriptor_function(
                        centroids.new_zeros(centroids.shape)),
                        centroids.new_zeros(centroids.shape[:1]))
                grouped.append(zeros[0])
                weights.append(zeros[1])
                continue
            desc, f, ass = self.assign_features(feat, att, centroids)
            grouped.append(self.descriptor_function(desc))
            weights.append(self.weight_function(desc, f, att, ass))
        return torch.stack(grouped), torch.stack(weights)

    def forward(self, images):
        spatial.refuse("the grouping layers")
        return self._forward([(torch.as_tensor(f), torch.as_tensor(a))
                              for f, a in images])


# clustering iterations (layers/functional.py:37-60)

def init_clusters_forgy(points, n_clusters, generator):
    """`n_clusters` distinct points drawn from `generator` (a
    torch.Generator on the points' device)."""
    idx = torch.randperm(points.shape[0], generator=generator,
                         device=points.device)[:n_clusters]
    return points[idx]


def iterate_kmeans(points, clusters, iterations):
    """Lloyd iterations; a cluster that no point chooses keeps its
    centroid. The argmin runs over the clusters in chunks (`nearest`)."""
    ones = points.new_ones((points.shape[0],))
    c = clusters
    for _ in range(int(iterations)):
        assignment = nearest(points, c, 1)[1][:, 0]
        sums = _segment_sum(points, assignment, c.shape[0])
        counts = _segment_sum(ones, assignment, c.shape[0])[:, None]
        c = torch.where(counts > 0, sums / counts.clamp(min=1), c)
    return c


def iterate_cmeans(points, clusters, iterations, fuzzifier, eps=EPS):
    c = clusters
    for _ in range(int(iterations)):
        w = assign_weights_cmeans(cdist(points, c), fuzzifier) ** fuzzifier
        c = (w.T @ points) / (w.T.sum(-1, keepdim=True) + eps)
    return c


def iterate_softmax(points, clusters, iterations, base, eps=EPS):
    c = clusters
    for _ in range(int(iterations)):
        w = assign_weights_softmax(cdist(points, c), base) ** base
        c = (w.T @ points) / (w.T.sum(-1, keepdim=True) + eps)
    return c


CLUSTERING_FUNCTIONS = {
    "kmeans": lambda: iterate_kmeans,
    "cmeans": lambda fuzzifier: (
        lambda f, c, i: iterate_cmeans(f, c, i, fuzzifier)),
    "softmax": lambda base: (lambda f, c, i: iterate_softmax(f, c, i, base)),
}


def _seeded(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


class BatchClustering(Grouping):
    """Per-batch clustering (grouping.py:174-193): each forward draws fresh
    Forgy clusters from the batch's detached features with its generator
    (seeded with `seed` on the features' device at the first forward, then
    advanced draw by draw), iterates the clustering and assigns."""

    def __init__(self, centroids, features, nearest, assignment, descriptor,
                 weights, clustering, iterations, *, outputdim, seed=0):
        super().__init__(centroids, features, nearest, assignment, descriptor,
                         weights)
        self.clustering = str_func_call(clustering, CLUSTERING_FUNCTIONS)
        self.params.update({"clustering": clustering,
                            "iterations": iterations})
        self.seed = seed
        self.generator = None

    def _forward(self, images):
        features = torch.cat([f.detach() for f, _ in images])
        if self.generator is None or \
                self.generator.device != features.device:
            self.generator = _seeded(self.seed, features.device)
        clusters = init_clusters_forgy(features, self.params["centroids"],
                                       self.generator)
        clusters = self.clustering(features, clusters,
                                   self.params["iterations"])
        return self.assign_images(images, clusters)


class Codebook(Grouping):
    """Codebook grouping with optional top-centroid reduction
    (grouping.py:199-295): `codebook` (K, D) is an nn.Parameter;
    `top_centroids` keeps the centroids most weighted by the first two
    images (query, positive) before the assignment (`reduce`)."""

    def __init__(self, codebook, features, nearest, assignment, descriptor,
                 weights, lr_multiplier=1.0, top_centroids=None):
        codebook = torch.as_tensor(codebook, dtype=torch.float32)
        super().__init__(codebook.shape[0], features, nearest, assignment,
                         descriptor, weights)
        self.codebook = nn.Parameter(codebook.clone())
        self.lr_multiplier = lr_multiplier
        self.top_centroids = parse_size(top_centroids) if top_centroids \
            else None
        if self.top_centroids and not any(
                self.params["weights"].lower().startswith(x)
                for x in ("max", "sum", "avg", "unif")):
            raise ValueError("top_centroids needs a max, sum, avg or unif "
                             "weight function, got %r"
                             % self.params["weights"])

    def _forward(self, images):
        codebook, images = self.reduce(images)
        return self.assign_images(images, codebook)

    def reduce(self, images):
        """(codebook, images) for the assignment: the whole codebook and the
        images as given without `top_centroids`; else the top-weighted
        centroids and, on the hard path, the images without the features
        assigned to a dropped centroid."""
        codebook = self.codebook
        if not self.top_centroids:
            return codebook, images
        pospair = images[:2]  # weights only from query + positive
        atts = torch.cat([a.detach() for _, a in pospair])
        if self.nearest is None:
            # soft path (grouping.py:217-221): soft-assign the pospair
            # features, keep the top-weighted centroids
            feats = torch.cat([f.detach() for f, _ in pospair])
            with torch.no_grad():
                ass = self.assignment_function(cdist(feats,
                                                      codebook.detach()))
                w = self.weight_function(None, None, atts, ass)
            top = torch.sort(w, descending=True, stable=True)[1]
            return _gather_rows(codebook, top[:self.top_centroids]), images
        # hard path (grouping.py:222-229 + _chunk_weights_topk +
        # _reduce_codebook): hard-assign every image feature, weight the
        # centroids by the pospair's one-hot assignments, drop the features
        # assigned to excluded centroids
        if self.nearest != 1:
            raise NotImplementedError("top_centroids with top-%d nearest "
                                      "(the reference has top-1 only)"
                                      % self.nearest)
        feats = torch.cat([f.detach() for f, _ in images])
        idx = nearest(feats, codebook.detach(), 1)[1][:, 0]
        w = self._pospair_weights(idx[:atts.shape[0]], atts,
                                  codebook.shape[0])
        keep, feature_mask = self._reduce_codebook(
            w.cpu().numpy(), idx.cpu().numpy(), np.arange(codebook.shape[0]),
            self.top_centroids)
        codebook = _gather_rows(codebook, torch.as_tensor(
            keep, device=codebook.device))
        if feature_mask is not None:
            images = self._filter_features(images, feature_mask)
        return codebook, images

    def _pospair_weights(self, idx, atts, n_centroids):
        """The weight function over the pospair's one-hot (n, K)
        assignment, column block by column block (each weight function
        reduces every column alone), so no (n, K) one-hot is made."""
        step = chunk_columns(idx.shape[0])
        cols = torch.arange(n_centroids, device=idx.device)
        out = []
        with torch.no_grad():
            for s in range(0, n_centroids, step):
                one_hot = (idx[:, None] == cols[None, s:s + step]).to(
                    atts.dtype)
                out.append(self.weight_function(None, None, atts, one_hot))
        return torch.cat(out)

    @staticmethod
    def _reduce_codebook(weights, assignment, codebook, top_centroids):
        """Reduce the codebook to the top-weighted centroids; return a mask
        of the flattened features assigned to the kept ones (grouping.py:
        278-293). Host-side numpy: the result shapes are data-dependent."""
        nonzero = weights > 0
        if nonzero.sum() < top_centroids:
            return codebook[np.nonzero(nonzero)[0]], None
        order = np.argsort(-weights[nonzero], kind="stable")
        idx = np.arange(nonzero.shape[0])[nonzero][order]
        reduced = codebook[idx[:top_centroids]]
        exclude = idx[top_centroids:]
        feature_mask = ~np.isin(assignment, exclude)
        return reduced, feature_mask

    @staticmethod
    def _filter_features(images, feature_mask):
        """Apply a flattened-feature boolean mask back onto the per-image
        feature / attention arrays (grouping.py:153-167)."""
        pointer = 0
        result = []
        for feat, att in images:
            mask = feature_mask[pointer:pointer + feat.shape[0]]
            keep = torch.as_tensor(np.nonzero(mask)[0], device=feat.device)
            result.append((feat[keep], att[keep]))
            pointer += feat.shape[0]
        if pointer != feature_mask.shape[0]:
            raise ValueError("the mask covers %d features, the images %d"
                             % (feature_mask.shape[0], pointer))
        return result


class LoadedCodebook(Codebook):
    """Codebook loaded from a pickle (grouping.py:312-325): a local file
    holding {"state": {"centroids": (K, D)}}, or the array itself."""

    def __init__(self, centroids, features, nearest, assignment, descriptor,
                 weights, lr_multiplier=1.0, top_centroids=None, *,
                 outputdim=None):
        super().__init__(self.load_codebook(centroids), features, nearest,
                         assignment, descriptor, weights, lr_multiplier,
                         top_centroids)

    @staticmethod
    def load_codebook(path):
        if not isinstance(path, str):
            return torch.as_tensor(np.asarray(path), dtype=torch.float32)
        if "://" in path:
            raise NotImplementedError(
                "codebook %r: only local files load (this package "
                "downloads nothing)" % path)
        with open(path, "rb") as handle:
            state = pickle.load(handle)
        return torch.as_tensor(np.asarray(state["state"]["centroids"]),
                               dtype=torch.float32)


class ClusteringCodebook(Codebook):
    """Codebook computed by k-means at the start of training
    (grouping.py:298-309)."""

    def __init__(self, centroids, features, nearest, assignment, descriptor,
                 weights, lr_multiplier=1.0, top_centroids=None,
                 iterations=10, *, outputdim, **inference_params):
        super().__init__(torch.zeros((parse_size(centroids), outputdim)),
                         features, nearest, assignment, descriptor, weights,
                         lr_multiplier, top_centroids)
        self.clustering = str_func_call("kmeans", CLUSTERING_FUNCTIONS)
        self.params["iterations"] = iterations

    def compute_codebook(self, descriptors, generator=None):
        """Forgy draws from `generator` (seed 0 on the descriptors' device
        by default), then the k-means iterations; the codebook takes the
        result on its own device."""
        descriptors = torch.as_tensor(descriptors)
        if generator is None:
            generator = _seeded(0, descriptors.device)
        centroids = init_clusters_forgy(descriptors, self.params["centroids"],
                                        generator)
        result = self.clustering(descriptors, centroids,
                                 self.params["iterations"])
        with torch.no_grad():
            self.codebook.data = result.to(self.codebook.device,
                                           self.codebook.dtype)


class FaissCodebook(ClusteringCodebook):
    """The reference's faiss-clustered codebook (grouping.py:329-343),
    computed by the exact k-means with faiss's default 25 iterations: the
    JAX package's path without faiss (faiss is not imported)."""

    def __init__(self, centroids, features, nearest, assignment, descriptor,
                 weights, lr_multiplier=1.0, top_centroids=None,
                 iterations=25, *, outputdim, **inference_params):
        super().__init__(centroids, features, nearest, assignment,
                         descriptor, weights, lr_multiplier, top_centroids,
                         iterations, outputdim=outputdim)


GROUPINGS = {
    "BatchClustering": BatchClustering,
    "ClusteringCodebook": ClusteringCodebook,
    "LoadedCodebook": LoadedCodebook,
    "FaissCodebook": FaissCodebook,
}
