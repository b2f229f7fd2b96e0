"""The build_index stage (counterpart of
gandtr_tpu/scenarios/index_stage.py): descriptors of an image list
through the infer stage's embedding output, into a serving index saved as
a pickle-free .npz that `serving.load_index` (of either package) loads
and `serve_http(..., indices=)` puts behind `:search`.

Config::

    build_index:
      __function__: gandtr_tpu.stages.build_index
      network: {model: {...}, path: <checkpoint>}   # infer-stage loader
      data: {image_dir: ..., transforms: ..., ...}  # infer-stage data
      index:
        path: <index.npz>
        dimensions: 512            # descriptor dim (default 512)
        skip_if_exists: true       # an existing file is kept
        pq:                        # optional: product-quantized index
          m: 16                    # bytes a row (D % m == 0)
          ksub: 256                # centroids a subspace (<= 256)
          rerank: 0                # exact re-rank depth (f32 on the host)
          train_size: 25600        # training subsample
          iters: 25
          opq_iters: 0             # > 0: learn the OPQ rotation

Image names come on stdin, as the infer stage's. Rows with a NaN (failed
images) are left out of the index. The index is built with the real
descriptor dimension (a ResNet's 2048 whatever `dimensions` says); k-means
and encoding run on the stage's device.
"""
import os

import numpy as np

from gandtr_tpu_torch.utils.io import resolve_path


def build_index(params, data, device=None):
    """Returns ({"path", "count", "failed"},), or ({"path", "count",
    "status": "skipped"},) for an existing file with skip_if_exists.
    Runs on cuda unless `device="cpu"`."""
    from gandtr_tpu_torch.scenarios.infer_stage import infer
    from gandtr_tpu_torch.serving import load_index
    from gandtr_tpu_torch.serving.index import RetrievalIndex
    from gandtr_tpu_torch.serving.pq import PQRetrievalIndex

    params = dict(params)
    cfg = dict(params.pop("index"))
    path = resolve_path(cfg.pop("path"))
    if not path.endswith(".npz"):
        path += ".npz"
    dims = int(cfg.pop("dimensions", 512))
    skip = bool(cfg.pop("skip_if_exists", True))
    pq_cfg = cfg.pop("pq", None)
    if cfg:
        raise ValueError("Unused index params: %s" % sorted(cfg))

    if skip and os.path.exists(path):
        idx = load_index(path, devices=[device])
        return ({"path": path, "count": len(idx), "status": "skipped"},)

    names = list(data[0]) if data else []
    infer_params = {"network": params.pop("network"),
                    "data": params.pop("data", {}),
                    "output": {"type": "embedding", "dimensions": dims}}
    if params:
        raise ValueError("Unused build_index params: %s" % sorted(params))
    (meta,) = infer(infer_params, (names,), device=device)

    rows = np.asarray(meta["vecs"]).T  # (N, D), in `names` order
    keep = ~np.isnan(rows).any(axis=1)
    if len(names) and rows.shape[1] != dims:
        dims = rows.shape[1]
    if pq_cfg is not None:
        pq_cfg = dict(pq_cfg)
        train_size = int(pq_cfg.pop("train_size", 25600))
        iters = int(pq_cfg.pop("iters", 25))
        opq_iters = int(pq_cfg.pop("opq_iters", 0))
        index = PQRetrievalIndex(dims, m=int(pq_cfg.pop("m", 16)),
                                 ksub=int(pq_cfg.pop("ksub", 256)),
                                 rerank=int(pq_cfg.pop("rerank", 0)),
                                 devices=[device])
        if pq_cfg:
            raise ValueError("Unused pq params: %s" % sorted(pq_cfg))
        if keep.any():
            train = rows[keep]
            if train.shape[0] > train_size:
                sel = np.random.RandomState(0).permutation(
                    train.shape[0])[:train_size]
                train = train[sel]
            index.fit(train, iters=iters, opq_iters=opq_iters)
    else:
        index = RetrievalIndex(dims, devices=[device])
    if keep.any():
        index.add([n for n, k in zip(names, keep) if k], rows[keep])
    index.save(path)
    return ({"path": path, "count": int(keep.sum()),
             "failed": int((~keep).sum())},)
