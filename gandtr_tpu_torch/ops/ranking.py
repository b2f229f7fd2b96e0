"""Retrieval ranking and mAP (counterpart of gandtr_tpu/ops/ranking.py).

Ranking is one float32 product `vecs.T @ qvecs` on the descriptors' device
(TF32 off, device.py, as JAX's Precision.HIGHEST) and a stable descending
sort per query, so equal scores keep the lower database index first, as in
the JAX package. The mAP is host numpy with junk-shifted ranks, as the
reference's evaluate.py computes it.
"""
import numpy as np
import torch

from gandtr_tpu_torch.device import resolve_device


def rank_descriptors(vecs, qvecs, device=None):
    """vecs (D, Ndb), qvecs (D, Nq), arrays or tensors -> (Ndb, Nq) int64
    ranks on the device: ranks[r, q] is the database index at rank r for
    query q. Tensors stay on their device; arrays go to `device` (cuda
    unless "cpu")."""
    if not isinstance(vecs, torch.Tensor):
        dev = resolve_device(device)
        vecs = torch.as_tensor(np.asarray(vecs, np.float32), device=dev)
    qvecs = torch.as_tensor(np.asarray(qvecs, np.float32)
                            if not isinstance(qvecs, torch.Tensor) else qvecs,
                            device=vecs.device)
    scores = vecs.float().T @ qvecs.float()
    # 0 - s, not -s: +0 and -0 become one key, so a sort that orders them
    # by sign bits cannot split a tie
    return torch.argsort(0.0 - scores, dim=0, stable=True)


def compute_ap(ranks, nres):
    """Average precision from the 0-based ranks of the positives."""
    ap = 0.0
    recall_step = 1.0 / nres
    for j, rank in enumerate(ranks):
        precision_0 = 1.0 if rank == 0 else float(j) / rank
        precision_1 = float(j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def compute_map(ranks, gnd, kappas=()):
    """mAP, per-query APs, mean precision@k and per-query precision@k.
    ranks: (Ndb, Nq) 0-based; gnd: a list of {"ok": [...], "junk": [...]}.
    A query without positives gets NaN and counts in no mean."""
    ranks = np.asarray(ranks)
    kappas = list(kappas)
    nq = len(gnd)
    mAP = 0.0
    aps = np.zeros(nq)
    pr = np.zeros(len(kappas))
    prs = np.zeros((nq, len(kappas)))
    nempty = 0
    for i in range(nq):
        qgnd = np.array(gnd[i]["ok"])
        if qgnd.shape[0] == 0:
            aps[i] = float("nan")
            prs[i, :] = float("nan")
            nempty += 1
            continue
        qgndj = np.array(gnd[i].get("junk", np.empty(0)))
        pos = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgnd)]
        junk = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgndj)]
        if len(junk):
            # each positive moves up by the junk ranked before it
            pos = pos - np.searchsorted(junk, pos)
        ap = compute_ap(pos, len(qgnd))
        mAP += ap
        aps[i] = ap
        pos = pos + 1  # 1-based for precision@k
        for j, kappa in enumerate(kappas):
            kq = min(max(pos), kappa)
            prs[i, j] = (pos <= kq).sum() / kq
        pr = pr + prs[i, :]
    denom = nq - nempty
    return mAP / denom, aps, pr / denom, prs


def compute_map_protocols(dataset, ranks, gnd, kappas=(1, 5, 10)):
    """The revisited datasets' Easy / Medium / Hard protocols (a plain
    {"ok", "junk"} gnd gives one "map"). Returns ({metric: mAP}, {metric:
    per-query APs})."""
    if "ok" in gnd[0]:
        m, aps, _, _ = compute_map(ranks, gnd)
        return {"map": m}, {"ap": aps}

    def protocol(ok_keys, junk_keys):
        gnd_t = [{"ok": np.concatenate([np.asarray(g[k]).ravel()
                                        for k in ok_keys]),
                  "junk": np.concatenate([np.asarray(g[k]).ravel()
                                          for k in junk_keys])}
                 for g in gnd]
        return compute_map(ranks, gnd_t, kappas)

    mapE, apsE, _, _ = protocol(["easy"], ["junk", "hard"])
    mapM, apsM, _, _ = protocol(["easy", "hard"], ["junk"])
    mapH, apsH, _, _ = protocol(["hard"], ["junk", "easy"])
    return ({"map_easy": mapE, "map_medium": mapM, "map_hard": mapH},
            {"ap_easy": apsE, "ap_medium": apsM, "ap_hard": apsH})
