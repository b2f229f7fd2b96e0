"""Product-quantized descriptor index (counterpart of
gandtr_tpu/serving/pq.py).

The exact index (serving/index.py) holds float32 rows on the device: 2 GB
for 1M x 512. PQ keeps one uint8 code a subspace instead (m bytes a row)
and scans by per-query lookup tables (asymmetric distance, ADC): rows and
queries are L2-normalized and ranked by inner product, so score(q, x) ~=
sum_m <q_m, C_m[code_m(x)]>. An optional exact re-rank of the PQ top-R
from float32 rows kept on the HOST recovers exact top-k quality with device
memory still O(N m). The API is RetrievalIndex's, so serve_http and the
build_index stage take either.

k-means, encoding and OPQ's codebook fits run on the index's first device
in float32 (TF32 off); OPQ's D x D SVD is host numpy. The initial
centroids are the rows of the same `np.random.RandomState(seed)`
permutation as the JAX package's, so both packages start from the same
centroids. Assignment ties go to the lower centroid (`argmax`'s first
maximum, as `jnp.argmax`).
"""
import json
import os
import threading

import numpy as np
import torch

from gandtr_tpu_torch.device import upload
from gandtr_tpu_torch.serving.index import (_resolve_devices, exact_topk,
                                            merge_topk_parts, shard_rows)


def train_product_quantizer(train_vecs, m, ksub=256, iters=25, seed=0,
                            device=None):
    """Lloyd k-means in each of the m subspaces at once, on `device` (cuda
    by default): assignment and update are batched matrix products over
    the (m, n, dsub) view. Returns (m, ksub, dsub) float32 codebooks (numpy).
    An empty cluster keeps its centroid."""
    X = np.ascontiguousarray(train_vecs, np.float32)
    n, d = X.shape
    if d % m:
        raise ValueError("dim %d not divisible by m=%d" % (d, m))
    if ksub > 256:
        raise ValueError("codes are uint8: ksub must be <= 256")
    ksub = min(ksub, n)
    rng = np.random.RandomState(seed)
    Xs = X.reshape(n, m, d // m).transpose(1, 0, 2)  # (m, n, dsub)
    init = Xs[:, rng.permutation(n)[:ksub], :]       # (m, ksub, dsub)
    dev = _resolve_devices([device])[0]
    with torch.inference_mode():
        Xt = upload(np.ascontiguousarray(Xs), dev)
        C = upload(np.ascontiguousarray(init), dev)
        for _ in range(iters):
            xc = torch.bmm(Xt, C.transpose(1, 2))           # (m, n, ksub)
            c2 = (C * C).sum(-1)
            assign = torch.argmax(2.0 * xc - c2[:, None, :], -1)
            oh = torch.nn.functional.one_hot(assign, ksub).to(Xt.dtype)
            sums = torch.bmm(oh.transpose(1, 2), Xt)        # (m, ksub, dsub)
            counts = oh.sum(1)[..., None]
            C = torch.where(counts > 0, sums / counts.clamp(min=1.0), C)
        return C.cpu().numpy()


def _decode(codebooks, codes):
    """(N, m) codes -> (N, D) reconstruction (host numpy)."""
    return np.concatenate([codebooks[mi, codes[:, mi]]
                           for mi in range(codebooks.shape[0])], axis=1)


def _assign(C, Xs):
    """Nearest centroid in each subspace: argmin ||x - c||^2 as
    argmax(2<x, c> - ||c||^2). C (m, ksub, dsub), Xs (n, m, dsub) tensors on
    one device -> (n, m) int64. The one definition k-means' encoding and
    OPQ share."""
    xc = torch.einsum("nmd,mkd->nmk", Xs, C)
    c2 = (C * C).sum(-1)
    return torch.argmax(2.0 * xc - c2[None], -1)


def encode_chunked(C_dev, X, m, chunk=8192):
    """(N, D) host rows -> (N, m) int64 codes (numpy), assigned on C_dev's
    device in bounded chunks."""
    out = []
    with torch.inference_mode():
        for i in range(0, X.shape[0], chunk):
            xs = upload(np.ascontiguousarray(X[i:i + chunk], np.float32),
                        C_dev.device)
            out.append(_assign(C_dev, xs.view(-1, m, X.shape[1] // m))
                       .cpu().numpy())
    return (np.concatenate(out, 0) if out
            else np.zeros((0, m), np.int64))


def train_opq_rotation(train_vecs, m, ksub=256, opq_iters=10, kmeans_iters=8,
                       seed=0, device=None):
    """OPQ-NP (Ge et al., CVPR'13): alternate the codebook fit, encoding and
    an SVD Procrustes update of an orthogonal rotation R minimizing
    ||XR - q(XR)||^2. Returns (R (D, D), codebooks), numpy float32."""
    X = np.ascontiguousarray(train_vecs, np.float32)
    d = X.shape[1]
    dev = _resolve_devices([device])[0]
    R = np.eye(d, dtype=np.float32)
    for _ in range(opq_iters):
        Xr = X @ R
        C = train_product_quantizer(Xr, m, ksub, iters=kmeans_iters,
                                    seed=seed, device=dev)
        codes = encode_chunked(upload(C, dev), Xr, m)
        U, _, Vt = np.linalg.svd(X.T @ _decode(C, codes),
                                 full_matrices=False)
        R = (U @ Vt).astype(np.float32)
    C = train_product_quantizer(X @ R, m, ksub, iters=kmeans_iters,
                                seed=seed, device=dev)
    return R, C


class PQRetrievalIndex:
    """RetrievalIndex-compatible PQ index.

    fit(train_vecs) trains the codebooks (or pass `codebooks=`); add()
    encodes rows to (N, m) uint8 codes; query() scans each shard on its
    device. With rerank=R > 0, float32 rows are kept on the HOST and the
    merged PQ top-R is re-scored exactly per query before the cut to k.
    With rotation=R (or fit(opq_iters=K)), rows and queries turn by the
    learned orthogonal OPQ matrix before quantization: inner products are
    kept, so rerank's meaning is unchanged."""

    def __init__(self, dim, m=16, ksub=256, devices=None, rerank=0,
                 codebooks=None, rotation=None):
        self.dim, self.m, self.ksub = int(dim), int(m), int(ksub)
        if self.dim % self.m:
            raise ValueError("dim %d not divisible by m=%d"
                             % (self.dim, self.m))
        self.rerank = int(rerank)
        self.devices = _resolve_devices(devices)
        self.codebooks = None if codebooks is None else \
            np.ascontiguousarray(codebooks, np.float32)
        self.rotation = None if rotation is None else \
            np.ascontiguousarray(rotation, np.float32)
        self.names = []
        self._codes = []         # (N_i, m) uint8 blocks (host)
        self._exact = []         # (N_i, D) float32 blocks (host), iff rerank
        self._shards = None
        self._names_snap = ()    # immutable snapshot, rebuilt with shards
        self._exact_full = None  # the concatenated _exact, ditto
        self._C_enc = None       # codebooks on the first device, encoding
        self._lock = threading.Lock()

    def __len__(self):
        return sum(c.shape[0] for c in self._codes)

    # ------------------------------------------------------------------ fit
    def fit(self, train_vecs, iters=25, seed=0, opq_iters=0):
        """opq_iters > 0 also learns the OPQ rotation.

        A refit after add() would pair old codes with new codebooks: with
        rerank (exact rows kept) the rows are encoded again here; without,
        it raises, before anything changes."""
        if self._codes and not self.rerank:
            raise RuntimeError(
                "fit() after add() without rerank: existing codes "
                "cannot be re-encoded (exact rows not kept) - fit "
                "before add, or use rerank>0")
        dev = self.devices[0]
        if opq_iters:
            rotation, codebooks = train_opq_rotation(
                train_vecs, self.m, self.ksub, opq_iters=opq_iters,
                kmeans_iters=max(iters // 3, 5), seed=seed, device=dev)
        else:
            rotation, codebooks = self.rotation, train_product_quantizer(
                train_vecs, self.m, self.ksub, iters=iters, seed=seed,
                device=dev)
        with self._lock:
            # swapped under the lock: a concurrent query or add never pairs
            # old codes with new codebooks
            self.rotation, self.codebooks = rotation, codebooks
            self._C_enc = None
            self._shards = None
            if self._codes:
                rows = np.concatenate(self._exact, 0)
                self._codes = [self._encode(self._rotate(rows))]
                self._exact = [rows]
        return self

    def _rotate(self, X):
        return X if self.rotation is None else X @ self.rotation

    # ------------------------------------------------------------------ add
    def _encode(self, X):
        if self._C_enc is None:
            self._C_enc = upload(self.codebooks, self.devices[0])
        return encode_chunked(self._C_enc, X, self.m).astype(np.uint8)

    def add(self, names, descriptors):
        if self.codebooks is None:
            raise ValueError("fit() or pass codebooks= first")
        X = np.ascontiguousarray(descriptors, np.float32)
        if X.ndim == 1:
            X = X[None]
        if X.shape != (len(names), self.dim):
            raise ValueError("descriptors shape %s != (%d, %d)"
                             % (X.shape, len(names), self.dim))
        with self._lock:
            # encoded under the lock: a fit() swapping codebooks mid-add
            # must not let old-codebook codes land after its re-encode
            codes = self._encode(self._rotate(X))  # exact rows UNROTATED
            self.names.extend(str(n) for n in names)
            self._codes.append(codes)
            if self.rerank:
                self._exact.append(X)
            self._shards = None

    # ---------------------------------------------------------------- query
    def _build_shards(self):
        full = (np.concatenate(self._codes, 0) if self._codes
                else np.zeros((0, self.m), np.uint8))
        # codes stay uint8 on the device (the point of PQ), one column a
        # subspace; the codebooks ride along on each shard's device
        self._shards = [
            (off, codes.T.contiguous(), upload(self.codebooks, dev))
            for (off, codes), dev in zip(shard_rows(full, self.devices),
                                         self.devices)]
        self._names_snap = tuple(self.names)
        self._exact_full = (np.concatenate(self._exact, 0) if self._exact
                            else np.zeros((0, self.dim), np.float32))

    def build(self):
        """Upload the codes now (else the first query does)."""
        with self._lock:
            if self._shards is None:
                self._build_shards()

    def scan(self, codes_t, C, q):
        """ADC scores (Nq, n) of q (Nq, D) against one shard's codes, given
        as (m, n) uint8 columns: the lookup tables by one batched product,
        then m gathers added in column order, as the JAX package's scan."""
        m, dsub = self.m, self.dim // self.m
        lut = torch.einsum("qmd,mkd->mqk", q.view(-1, m, dsub), C)
        scores = torch.index_select(lut[0], 1, codes_t[0].int())
        for mi in range(1, m):
            scores = scores + torch.index_select(lut[mi], 1,
                                                 codes_t[mi].int())
        return scores

    def query(self, qvecs, k=10):
        """RetrievalIndex.query's contract; the scores are PQ estimates
        unless rerank covers k."""
        q = np.asarray(qvecs, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise ValueError("query dim %d != index dim %d"
                             % (q.shape[1], self.dim))
        with self._lock:
            if self._shards is None:
                self._build_shards()
            shards, names, X = self._shards, self._names_snap, \
                self._exact_full
        n = len(names)
        if n == 0:
            return [[] for _ in range(q.shape[0])]
        k = min(int(k), n)
        kfetch = min(max(k, self.rerank), n) if self.rerank else k
        # the rotation is orthogonal: <qR, xR> == <q, x>
        qr = np.ascontiguousarray(self._rotate(q), np.float32)
        on_dev = {}
        parts = []
        with torch.inference_mode():
            for offset, codes_t, C in shards:
                if codes_t.shape[1] == 0:
                    continue
                if C.device not in on_dev:
                    on_dev[C.device] = upload(qr, C.device)
                vals, idx = exact_topk(self.scan(codes_t, C,
                                                 on_dev[C.device]),
                                       min(kfetch, codes_t.shape[1]))
                parts.append((vals, idx, offset))
            vals, idx = merge_topk_parts(parts, kfetch)
        if self.rerank:
            out = []
            for qi in range(q.shape[0]):
                cand = idx[qi]
                ex = X[cand] @ q[qi]
                order = np.argsort(-ex, kind="stable")[:k]
                out.append([(names[cand[j]], float(ex[j])) for j in order])
            return out
        return [[(names[idx[qi, j]], float(vals[qi, j]))
                 for j in range(min(k, vals.shape[1]))]
                for qi in range(q.shape[0])]

    # ------------------------------------------------------------- persist
    def save(self, path):
        """Pickle-free .npz, the JAX package's keys."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            codes = (np.concatenate(self._codes, 0) if self._codes
                     else np.zeros((0, self.m), np.uint8))
            exact = (np.concatenate(self._exact, 0) if self._exact
                     else np.zeros((0, self.dim), np.float32))
            names = np.asarray(self.names, dtype=str)
        codebooks = (self.codebooks if self.codebooks is not None
                     else np.zeros((0, 0, 0), np.float32))
        rotation = (self.rotation if self.rotation is not None
                    else np.zeros((0, 0), np.float32))
        np.savez_compressed(
            path, codes=codes, names=names, codebooks=codebooks,
            rotation=rotation, exact=exact,
            meta=json.dumps({"dim": self.dim, "m": self.m, "ksub": self.ksub,
                             "rerank": self.rerank}))

    @classmethod
    def load(cls, path, devices=None, rerank=None):
        with np.load(path if str(path).endswith(".npz")
                     else str(path) + ".npz") as z:
            meta = json.loads(str(z["meta"]))
            if rerank is None:
                rerank = meta["rerank"]
            cb = z["codebooks"] if z["codebooks"].size else None
            rot = (z["rotation"] if "rotation" in z.files and
                   z["rotation"].size else None)
            idx = cls(meta["dim"], m=meta["m"], ksub=meta["ksub"],
                      devices=devices, rerank=rerank, codebooks=cb,
                      rotation=rot)
            codes = z["codes"].astype(np.uint8)
            if codes.shape[0]:
                idx.names = [str(n) for n in z["names"]]
                idx._codes = [codes]
                if rerank:
                    if z["exact"].shape[0] != codes.shape[0]:
                        raise ValueError(
                            "index was saved without exact rows; "
                            "rerank impossible")
                    idx._exact = [z["exact"]]
        return idx
