"""Hard-negative mining and diverse-anchor selection for tuple training
(counterpart of gandtr_tpu/data/mining.py; the reference's cirtorch
TuplesDataset mining and DiverseAnchorsDataset).

Descriptor extraction (the caller's `extract_fn`) and the `poolvecs.T @
qvecs` ranking run on the device; the greedy selection loops run on the
host in numpy, as in the JAX package, and draw from the miner's own
`numpy.random.RandomState(seed)`, so the same descriptors give the same
tuples.

The ranking matrix stays on the device: the greedy negative search reads
only each query's leading rows, so it copies a block of leading rows to
the host and copies the next block only when some query has not found its
`nnum` clusters in the rows copied so far. Its picks are those of the
search over the whole matrix (tests/test_torch_finetune_loop.py holds it).
"""
import numpy as np
import torch

from gandtr_tpu_torch.ops.ranking import rank_descriptors

LEAD_ROWS = 64      # ranks copied to the host first, for every query


def cid2filename(cid, prefix=""):
    """retrieval-SfM cid -> its nested path (cirtorch's datahelpers.py):
    an absolute cid passes through; a '*' in the prefix takes the hash
    path's place."""
    if cid and cid[0] == "/":
        return cid
    path = "/".join([cid[-2:], cid[-4:-2], cid[-6:-4], cid])
    if "*" in prefix:
        return prefix.replace("*", path)
    return "/".join([prefix, path]) if prefix else path


def _host_rows(ranks, start, stop):
    """Rows [start, stop) of a (Npool, Nq) rank matrix, as a host array."""
    block = ranks[start:stop]
    if isinstance(block, torch.Tensor):
        return block.cpu().numpy()
    return np.asarray(block)


def search_hard_negatives(qvecs, poolvecs, qidxs, idxs2images, clusters,
                          nnum, rank_fn=None, device=None, lead=LEAD_ROWS):
    """Greedy top-ranked negatives with cluster dedup (cirtorch's
    traindataset.py). qvecs (D, Nq), poolvecs (D, Npool), host arrays.
    Returns (nidxs, stats).

    The ranks come from `rank_fn(poolvecs, qvecs)` or else
    `ops.ranking.rank_descriptors` on `device`; the host reads their
    leading `lead` rows and doubles that only when a query needs more."""
    if rank_fn is None:
        ranks = rank_descriptors(poolvecs, qvecs, device=device)
    else:
        ranks = rank_fn(poolvecs, qvecs)
    npool = ranks.shape[0]
    host = _host_rows(ranks, 0, min(int(lead), npool))
    qvecs = np.asarray(qvecs)
    poolvecs = np.asarray(poolvecs)
    nidxs = []
    ndist_acc = []
    for q in range(len(qidxs)):
        qcluster = clusters[qidxs[q]]
        picked_clusters = [qcluster]
        nidx = []
        r = 0
        while len(nidx) < nnum:
            if r == host.shape[0]:
                if r == npool:
                    raise IndexError("query %d: the pool holds fewer than %d "
                                     "clusters apart from its own" % (q, nnum))
                host = np.concatenate(
                    [host, _host_rows(ranks, r, min(2 * r, npool))])
            pool_pos = host[r, q]
            potential = idxs2images[pool_pos]
            if clusters[potential] not in picked_clusters:
                nidx.append(potential)
                picked_clusters.append(clusters[potential])
                ndist = np.sqrt(np.sum(
                    (qvecs[:, q] - poolvecs[:, pool_pos] + 1e-6) ** 2))
                ndist_acc.append(float(ndist))
            r += 1
        nidxs.append(nidx)
    return nidxs, {"average_negative_distance": ndist_acc}


def select_diverse_queries(qvecs, qsize, similar_exclude, similar_include,
                           shuffle=True, rng=None):
    """Greedy diverse-anchor selection (cirtorch_datasets.py): each next
    query is drawn from a percentile window of its highest similarity to
    the queries picked so far. qvecs (D, Nqpool). Returns (indices,
    score_acc)."""
    rng = rng or np.random
    qvecs = np.asarray(qvecs)
    qpool_size = qvecs.shape[1]
    idx = 0
    idxs = [idx]
    most_similar = np.full(qpool_size, -np.inf)
    qscore_acc = []
    for _ in range(qsize - 1):
        dist = qvecs.T @ qvecs[:, idx]
        most_similar = np.maximum(most_similar, dist)
        valid_size = qpool_size - len(idxs)
        similar_split = max(int(valid_size * (1 - similar_exclude)), 1)
        dissimilar_split = min(int(valid_size * (1 - similar_include)),
                               similar_split - 1)
        order = np.argsort(most_similar, kind="stable")
        dissimilar_part = order[dissimilar_split:similar_split]
        if shuffle:
            choice = int(rng.randint(dissimilar_part.shape[0]))
        else:
            choice = dissimilar_part.shape[0] - 1
        idx = int(dissimilar_part[choice])
        qscore_acc.append(float(most_similar[idx]))
        idxs.append(idx)
    return idxs, qscore_acc


def mark_easy_difficulties(qvecs, pvecs, mark_easy, qsize):
    """"-easy" / "-hard" label suffixes: the top `mark_easy * qsize` tuples
    by anchor-positive similarity are easy (cirtorch_datasets.py)."""
    sim_ord = np.argsort(np.sum(np.asarray(qvecs) * np.asarray(pvecs),
                                axis=0), kind="stable")
    easy_set = set(sim_ord[-int(mark_easy * qsize):].tolist())
    return ["-easy" if i in easy_set else "-hard"
            for i in range(qvecs.shape[1])]


class TuplesMiner:
    """Tuple mining at each epoch's start (the reference's
    create_epoch_tuples).

    db: {"qidxs", "pidxs", "cluster", "cids" or "ids" or "images"}.
    `extract_fn(image_indices, label=...) -> (D, N)` host descriptors is
    the caller's; `label` names the extraction ("anc-mine",
    "neg-pool-mine", ...) for the augmentation gate's regex. `device` is
    where the ranking runs."""

    def __init__(self, db, nnum=5, qsize=2000, poolsize=22000, shuffle=True,
                 seed=0, qpool_size=None, similar_exclude=None,
                 similar_include=None, mark_easy=None, first_neg="neg",
                 device=None):
        self.db = db
        self.nnum = nnum
        self.num_images = len(db.get("cids", db.get("ids",
                                                    db.get("images", []))))
        self.qsize = min(qsize, len(db["qidxs"]))
        self.poolsize = min(poolsize, self.num_images)
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.device = device
        self.diverse = qpool_size is not None
        if first_neg not in ("neg", "pos", "exc"):
            raise ValueError("first_neg must be neg, pos or exc, got %r"
                             % first_neg)
        self.first_neg = first_neg
        self.mark_easy = mark_easy if mark_easy is None else float(mark_easy)
        if self.mark_easy is not None and not (
                self.diverse and 0 <= self.mark_easy <= 1):
            raise ValueError("mark_easy needs qpool_size and a value in "
                             "[0, 1], got %r" % mark_easy)
        if self.diverse:
            self.qpool_size = min(qpool_size, len(db["qidxs"]))
            # the reference fails fast: more diverse queries than the pool
            # holds would pick some twice
            if self.qsize > self.qpool_size:
                raise ValueError("query_size %d > qpool_size %d"
                                 % (self.qsize, self.qpool_size))
            self.similar_exclude = similar_exclude
            self.similar_include = similar_include

    def _randperm(self, size, samples):
        if self.shuffle:
            return list(self.rng.permutation(size)[:samples])
        return list(range(size))[:samples]

    def create_epoch_tuples(self, extract_fn):
        """Returns (qidxs, pidxs, nidxs, labels, stats)."""
        stats = {}
        if self.diverse:
            idxs2qpool = self._randperm(len(self.db["qidxs"]),
                                        self.qpool_size)
            qidxs = [self.db["qidxs"][i] for i in idxs2qpool]
            pidxs = [self.db["pidxs"][i] for i in idxs2qpool]
            qvecs = np.asarray(extract_fn(qidxs, label="anc-pool-mine"))
            sel, qscore = select_diverse_queries(
                qvecs, self.qsize, self.similar_exclude,
                self.similar_include, self.shuffle, self.rng)
            qidxs = [qidxs[i] for i in sel]
            pidxs = [pidxs[i] for i in sel]
            qvecs = qvecs[:, sel]
            stats["average_new_query_max_score"] = qscore
            if self.mark_easy is not None:
                pvecs = np.asarray(extract_fn(pidxs, label="pos-pool-mine"))
                self._difficulties = mark_easy_difficulties(
                    qvecs, pvecs, self.mark_easy, self.qsize)
        else:
            idxs2qpool = self._randperm(len(self.db["qidxs"]), self.qsize)
            qidxs = [self.db["qidxs"][i] for i in idxs2qpool]
            pidxs = [self.db["pidxs"][i] for i in idxs2qpool]
            if self.nnum:
                # without negatives the anchors' descriptors are not needed
                qvecs = np.asarray(extract_fn(qidxs, label="anc-mine"))

        if self.nnum == 0:
            return (qidxs, pidxs, [[] for _ in qidxs],
                    self._labels(len(qidxs)), stats)

        idxs2images = self._randperm(self.num_images, self.poolsize)
        poolvecs = np.asarray(extract_fn(idxs2images, label="neg-pool-mine"))
        nidxs, nstats = search_hard_negatives(
            qvecs, poolvecs, qidxs, idxs2images, self.db["cluster"],
            self.nnum, device=self.device)
        stats.update(nstats)
        return qidxs, pidxs, nidxs, self._labels(len(qidxs)), stats

    def _labels(self, n):
        """Per-position label rows: "-easy" / "-hard" suffixes under
        mark_easy, and the first_neg override."""
        rows = ["anc", "pos"]
        if self.nnum:
            rows += [self.first_neg] + ["neg"] * (self.nnum - 1)
        diffs = getattr(self, "_difficulties", None) or [""] * n
        return [[x + y for y in diffs] for x in rows]
