"""In-memory descriptor index with exact top-k search on the device
(counterpart of gandtr_tpu/serving/index.py).

The database lives on the device(s) and each query is one float32 matmul
(TF32 off, device.py) and an exact top-k. Several devices (or several
shards on one device) hold contiguous equal-size row blocks; each shard's
top-k comes back to the host and the parts merge there, exact.

Tie order is that of the JAX package's `lax.top_k` at every level: the
higher score first, and among equal scores the lower row index first.
`torch.topk` promises no order among ties, so the top-k runs on int64 keys
that hold the score's float32 bits (mapped to an order-preserving integer)
above the complement of the row index: every key is unique and orders as
(score descending, index ascending), so any top-k returns the same rows in
the same order, within a chunk, at the candidate merge, and on any device.
The shards merge by a stable host sort, earlier shards first.

`save`/`load` use the JAX package's pickle-free `.npz` keys (`vecs`,
`names`, `meta`), so an index saved by either package loads in the other.
"""
import json
import os
import threading

import numpy as np
import torch

from gandtr_tpu_torch.device import resolve_device, upload

_LOW = 0xFFFFFFFF
_PAD_KEY = torch.iinfo(torch.int64).min


def shard_rows(full, devices):
    """Split rows into contiguous equal-size blocks over `devices`; returns
    [(offset, tensor on its device)]."""
    bounds = np.linspace(0, full.shape[0], len(devices) + 1).astype(int)
    return [(int(bounds[i]), upload(full[bounds[i]:bounds[i + 1]], dev))
            for i, dev in enumerate(devices)]


def merge_topk_parts(parts, k):
    """Merge per-shard (vals, local_idx, offset) top-k parts on the host
    into global (vals (Nq, k), idx (Nq, k)), best first; a stable sort, so
    earlier shards (lower global indices) win ties."""
    vals = np.concatenate([np.asarray(v.cpu()) for v, _, _ in parts], 1)
    idx = np.concatenate([np.asarray(i.cpu()) + off for _, i, off in parts],
                         1)
    order = np.argsort(-vals, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(idx, order, 1))


def score_keys(s):
    """(Nq, n) float32 scores -> (Nq, n) int64 keys, unique in a row and
    ordered as (score descending, column ascending)."""
    bits = s.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(s.shape[1], dtype=torch.int64, device=s.device)
    return (ordered << 32) | (_LOW - col)


def key_scores(keys):
    """The inverse of `score_keys`: (float32 scores, int64 columns)."""
    ordered = keys >> 32
    bits = torch.where(ordered < 0, ordered ^ 0x7FFFFFFF, ordered)
    return (bits.to(torch.int32).view(torch.float32),
            _LOW - (keys & _LOW))


def _topk_keys(keys, k, chunk):
    """The k largest keys of each row, largest first, by RECURSIVE
    chunking: the top-k of each `chunk` columns, then the same over the
    candidates, until a row is at most 4 chunks long."""
    n = keys.shape[1]
    if n <= 4 * chunk:
        return torch.topk(keys, k, dim=1).values
    pad = (-n) % chunk
    if pad:
        keys = torch.cat([keys, keys.new_full((keys.shape[0], pad),
                                              _PAD_KEY)], 1)
    cand = torch.topk(keys.view(keys.shape[0], -1, chunk), k, dim=2,
                      sorted=False).values
    return _topk_keys(cand.reshape(keys.shape[0], -1), k, chunk)


def exact_topk(s, k, chunk=128):
    """Exact top-k over long float32 score rows (Nq, n): (vals, idx), each
    (Nq, k), best first, the lower index first among equal scores (the JAX
    package's `exact_topk` and `lax.top_k`). `chunk` >= 2k, so that each
    level at least halves the candidates."""
    return key_scores(_topk_keys(score_keys(s), k, max(chunk, 2 * k)))


def _resolve_devices(devices):
    return [resolve_device(d) for d in (devices or [None])]


class RetrievalIndex:
    """Exact cosine / inner-product top-k over L2-normalized descriptor
    rows.

    add() appends (names, (N, D) rows); query() returns per query
    [(name, score), ...] best first. The database uploads (split into
    contiguous equal-size blocks over `devices`, cuda by default) at the
    first query after a change. Several entries of `devices` may name one
    device."""

    _CHUNK = 128

    def __init__(self, dim, devices=None):
        self.dim = int(dim)
        self.names = []
        self._vecs = []          # (N_i, D) float32 blocks on the host
        self.devices = _resolve_devices(devices)
        self._shards = None      # [(offset, tensor)], built lazily
        self._names_snap = ()    # immutable snapshot, rebuilt with shards
        # serve_http answers requests in threads: add and query must not
        # see a half-built shard list
        self._lock = threading.Lock()

    def __len__(self):
        return sum(v.shape[0] for v in self._vecs)

    def add(self, names, descriptors):
        descriptors = np.ascontiguousarray(descriptors, np.float32)
        if descriptors.ndim == 1:
            descriptors = descriptors[None]
        if descriptors.shape != (len(names), self.dim):
            raise ValueError("descriptors shape %s != (%d, %d)"
                             % (descriptors.shape, len(names), self.dim))
        with self._lock:
            self.names.extend(str(n) for n in names)
            self._vecs.append(descriptors)
            self._shards = None

    def _full(self):
        if not self._vecs:
            return np.zeros((0, self.dim), np.float32)
        return (self._vecs[0] if len(self._vecs) == 1
                else np.concatenate(self._vecs, 0))

    def _build_shards(self):
        self._shards = shard_rows(self._full(), self.devices)
        self._names_snap = tuple(self.names)

    def build(self):
        """Upload the database now (else the first query does)."""
        with self._lock:
            if self._shards is None:
                self._build_shards()

    def _search(self, db, q, k):
        """One shard's (vals, idx) top-k of q (Nq, D) against db (n, D)."""
        return exact_topk(torch.matmul(q, db.T), k, self._CHUNK)

    def query(self, qvecs, k=10):
        """qvecs: (Nq, D) or (D,) rows. Returns a list per query of
        [(name, score), ...], length min(k, len(index)), best first."""
        q = np.asarray(qvecs, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise ValueError("query dim %d != index dim %d"
                             % (q.shape[1], self.dim))
        with self._lock:  # a consistent (names, shards) view
            if self._shards is None:
                self._build_shards()
            shards, names = self._shards, self._names_snap
        n = len(names)
        if n == 0:
            return [[] for _ in range(q.shape[0])]
        k = min(int(k), n)
        on_dev = {}      # the queries, uploaded once a device
        parts = []
        with torch.inference_mode():
            for offset, db in shards:
                if db.shape[0] == 0:
                    continue
                if db.device not in on_dev:
                    on_dev[db.device] = upload(q, db.device)
                vals, idx = self._search(db, on_dev[db.device],
                                         min(k, db.shape[0]))
                parts.append((vals, idx, offset))
            vals, idx = merge_topk_parts(parts, k)
        return [[(names[idx[qi, j]], float(vals[qi, j]))
                 for j in range(vals.shape[1])] for qi in range(q.shape[0])]

    def save(self, path):
        """One pickle-free .npz (names as a unicode array); load with
        `RetrievalIndex.load` here or in the JAX package."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            full = self._full()
            names = np.asarray(self.names, dtype=str)
        np.savez_compressed(path, vecs=full, names=names,
                            meta=json.dumps({"dim": self.dim}))

    @classmethod
    def load(cls, path, devices=None):
        with np.load(path if str(path).endswith(".npz")
                     else str(path) + ".npz") as z:
            meta = json.loads(str(z["meta"]))
            idx = cls(meta["dim"], devices=devices)
            vecs = z["vecs"]
            if vecs.shape[0]:
                idx.add([str(n) for n in z["names"]], vecs)
        return idx
