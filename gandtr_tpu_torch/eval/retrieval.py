"""Retrieval evaluation: dataset configs, descriptor extraction, mAP
(counterpart of gandtr_tpu/eval/retrieval.py).

The reference's chain: a gnd_<dataset>.pkl names the database and query
images (with a bbx per query); each image is decoded, cropped to its bbx,
resized to its longest side with LANCZOS, preprocessed and embedded one at
a time; the database is ranked for each query by `V.T @ Q` and scored by
the E/M/H protocol mAP.

Host threads decode and resize ahead of the device (`_prefetched`); they
never touch CUDA. The extractor uploads each batch and leaves its
descriptors on the device, so nothing waits for the card until the last
image of a dataset is enqueued. With `shape_bucket`, images pad up to
multiples of it and a mask rides along: the masked net (ops/maskprop.py)
gives the exact-shape descriptors, CLAHE takes each image's own geometry
(K4 on the card), and multiscale resizes each image's rectangle.

Extraction is data-parallel two ways, as in the JAX package: an
extractor given `devices` sends its successive batches round-robin to
them, and under a process group (parallel/mesh.py) each rank extracts
every N-th image and the descriptors are gathered back in input order.
An image's descriptor does not depend on which rank or device ran it, so
both give one process's descriptors bit for bit (with batch_size 1; a
larger batch groups each rank's images among themselves).
"""
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gandtr_tpu_torch.data.cir_datasets import imresize
from gandtr_tpu_torch.data.datasets import imread
from gandtr_tpu_torch.device import upload
from gandtr_tpu_torch.ops.maskprop import mask_from_sizes
from gandtr_tpu_torch.ops.ranking import (compute_map_protocols,
                                          rank_descriptors)
from gandtr_tpu_torch.parallel import mesh
from gandtr_tpu_torch.utils.io import load_pickle

DATASETS = ["oxford5k", "paris6k", "roxford5k", "rparis6k", "247tokyo1k"]


def configdataset(dataset, dir_main):
    """The test-set config of `dataset` from
    <dir_main>/<dataset>/gnd_<dataset>.pkl (cirtorch's testdataset.py)."""
    dataset = dataset.lower()
    if dataset not in DATASETS:
        raise ValueError("Unknown dataset: {}!".format(dataset))
    gnd_fname = os.path.join(dir_main, dataset, "gnd_{}.pkl".format(dataset))
    cfg = load_pickle(gnd_fname)
    cfg["gnd_fname"] = gnd_fname
    cfg["ext"] = ".jpg"
    cfg["qext"] = ".jpg"
    cfg["dir_data"] = os.path.join(dir_main, dataset)
    cfg["dir_images"] = os.path.join(cfg["dir_data"], "jpg")
    cfg["n"] = len(cfg["imlist"])
    cfg["nq"] = len(cfg["qimlist"])
    cfg["dataset"] = dataset
    return cfg


def configdataset_tsv(dataset):
    """A test-set config from the reference's tsv dataset form {name,
    queries, db, imgdir} (cirscore.py:26-40): the db file's `identifier`
    column gives the database order; the queries file has `query`, `bbx`,
    `ok` and `junk` columns, the last three JSON lists in brackets. Read
    through utils/file_readers.py (tsv, csv, pkl, h5, lst, json)."""
    from gandtr_tpu_torch.data.datasets import path_join
    from gandtr_tpu_torch.utils.file_readers import initialize_file_reader
    from gandtr_tpu_torch.utils.io import resolve_path

    if dataset.keys() != {"name", "queries", "db", "imgdir"}:
        raise ValueError("a tsv dataset takes exactly name, queries, db and "
                         "imgdir, got %s" % sorted(dataset))
    imgdir = dataset["imgdir"]
    with initialize_file_reader(resolve_path(dataset["db"]),
                                keys=["identifier"]) as reader:
        identifiers = reader.get()["identifier"]
    images = [path_join(imgdir, x) for x in identifiers]
    mapping = {x: i for i, x in enumerate(identifiers)}
    with initialize_file_reader(resolve_path(dataset["queries"]),
                                keys=["query", "bbx", "ok", "junk"]) as reader:
        data = reader.get()
    qimages = [path_join(imgdir, x) for x in data["query"]]
    bbxs = [tuple(x) if x else None for x in data["bbx"]]
    gnd = [{"ok": [mapping[x] for x in ok],
            "junk": [mapping[x] for x in junk]}
           for ok, junk in zip(data["ok"], data["junk"])]
    return {"dataset": dataset["name"], "im_paths": images,
            "qim_paths": qimages, "bbxs": bbxs, "gnd": gnd,
            "n": len(images), "nq": len(qimages)}


def im_fname(cfg, i):
    if "im_paths" in cfg:
        return cfg["im_paths"][i]
    return os.path.join(cfg["dir_images"], cfg["imlist"][i] + cfg["ext"])


def qim_fname(cfg, i):
    if "qim_paths" in cfg:
        return cfg["qim_paths"][i]
    return os.path.join(cfg["dir_images"], cfg["qimlist"][i] + cfg["qext"])


class ShapeCachedExtractor:
    """Descriptor extraction on a device, or round-robin over several.

    `forward(x)` (exact shapes) or `forward(x, mask, host_hw)` (with
    `shape_bucket`) maps an uploaded (N, H, W, C) batch to (N, D)
    descriptors on the device; `host_hw` is the list of each row's valid
    (h, w). Images that share a `group_key` can go through one `batch`.
    PyTorch needs no per-shape compile, so unlike the JAX package's class of
    this name it caches nothing; the name is kept for the reader.

    With `devices` (a list), successive calls go round-robin to them, as
    the JAX package's do: the batch is uploaded there and `forward` must
    run on the device it is given (the caller keeps a model on each). The
    descriptors stay where they were made until the caller reads them."""

    def __init__(self, forward, shape_bucket=None, device="cpu",
                 devices=None):
        self.forward = forward
        self.shape_bucket = shape_bucket
        self.device = torch.device(device)
        self.devices = [torch.device(d) for d in devices] if devices \
            else None
        self._rr = 0

    def group_key(self, img_np):
        """The padded bucket shape when bucketing, else the exact shape."""
        H, W = img_np.shape[:2]
        if self.shape_bucket:
            b = self.shape_bucket
            return (-(-H // b) * b, -(-W // b) * b) + tuple(img_np.shape[2:])
        return tuple(img_np.shape)

    def _pad_and_mask(self, img_np):
        """Zero-pad an image to its bucket -> (padded, (h, w)); the mask is
        made on the device from the sizes. With the per-layer re-masking of
        ops/maskprop.py the zero band is the exact-shape forward's own zero
        padding at the valid border."""
        Hp, Wp = self.group_key(img_np)[:2]
        H, W = img_np.shape[:2]
        pad = ((0, Hp - H), (0, Wp - W)) + ((0, 0),) * (img_np.ndim - 2)
        return np.pad(img_np, pad), (H, W)

    def _upload(self, arr):
        return upload(arr, self.device)

    def _next_device(self):
        if not self.devices:
            return self.device
        d = self.devices[self._rr % len(self.devices)]
        self._rr += 1
        return d

    @torch.inference_mode()
    def _run(self, imgs_np):
        dev = self._next_device()
        if not self.shape_bucket:
            return self.forward(upload(np.stack(imgs_np), dev))
        padded, sizes = zip(*(self._pad_and_mask(im) for im in imgs_np))
        x = upload(np.stack(padded), dev)
        hw = upload(np.asarray(sizes, np.int64), dev)
        mask = mask_from_sizes((hw[:, 0], hw[:, 1]), x.shape[1], x.shape[2])
        return self.forward(x, mask, list(sizes))

    def __call__(self, img_np):
        """(H, W, C) host image -> (D,) descriptor on the device."""
        return self._run([img_np])[0]

    def batch(self, imgs_np):
        """Images of one `group_key` -> a list of (D,) descriptors on the
        device."""
        return list(self._run(list(imgs_np)))


def _load_preprocessed(path, image_size, transform, bbx=None):
    """Decode, crop to `bbx`, resize (a cropped query by its share of the
    full image's longest side, as the reference does) and transform."""
    img = imread(path)
    imfullsize = max(img.size)
    if bbx:
        img = img.crop(bbx)
    if image_size is not None:
        if bbx:
            img = imresize(img, image_size * max(img.size) / imfullsize)
        else:
            img = imresize(img, image_size)
    if transform:
        return np.asarray(transform(img))
    return np.asarray(img, np.float32) / 255.0


def _prefetched(n, loadfn, workers=2, depth=8):
    """Yield (i, loadfn(i)) in order while a small thread pool preloads up
    to `depth` items ahead: host decoding overlaps the device's work, with
    at most `depth` images held."""
    if n <= 1 or depth <= 1:
        for i in range(n):
            yield i, loadfn(i)
        return
    ex = ThreadPoolExecutor(workers)
    try:
        dq = deque(ex.submit(loadfn, i) for i in range(min(depth, n)))
        for i in range(n):
            arr = dq.popleft().result()
            if i + depth < n:
                dq.append(ex.submit(loadfn, i + depth))
            yield i, arr
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def extract_vectors(extractor, image_paths, image_size, transform, bbxs=None,
                    print_freq=500, batch_size=1, prefetch=8):
    """Descriptors of a list of images -> (D, N) numpy, in input order.

    With batch_size > 1, images of one `group_key` are buffered and run
    together; the buffer is capped, and at the cap the fullest group runs as
    a partial batch. Descriptors stay on the device until all are enqueued.
    Under a process group this rank extracts images r, r + N, ... and the
    descriptors of all are gathered back in input order.
    """
    n_all = len(image_paths)
    owners = [mesh.strided_share(n_all, r) for r in range(mesh.world_size())]
    mine = owners[mesh.rank()]
    n = len(mine)
    vecs = [None] * n
    done = 0

    def flush(batch):
        nonlocal done
        idxs, arrs = zip(*batch)
        outs = [extractor(arrs[0])] if len(arrs) == 1 \
            else extractor.batch(list(arrs))
        for i, v in zip(idxs, outs):
            vecs[i] = v
        done += len(batch)
        if done % print_freq < len(batch) or done == n:
            print("\r>>>> {}/{} done...".format(done, n), end="")

    def load(j):
        i = mine[j]
        return _load_preprocessed(image_paths[i], image_size, transform,
                                  bbxs[i] if bbxs is not None else None)

    buffers = {}
    buffered = 0
    max_buffered = max(batch_size * 8, 64)
    for i, arr in _prefetched(n, load, depth=max(prefetch, batch_size)):
        key = extractor.group_key(arr)
        buffers.setdefault(key, []).append((i, arr))
        buffered += 1
        if len(buffers[key]) >= batch_size:
            buffered -= len(buffers[key])
            flush(buffers.pop(key))
        elif buffered >= max_buffered:
            fullest = max(buffers, key=lambda k: len(buffers[k]))
            buffered -= len(buffers[fullest])
            flush(buffers.pop(fullest))
    for batch in buffers.values():
        flush(batch)
    print("")
    # one device for the stack and the gather: a round-robin extractor's
    # rows move to its first
    home = (getattr(extractor, "devices", None) or [extractor.device])[0]
    local = torch.stack([v.to(home) for v in vecs]).float() if vecs \
        else torch.zeros((0, 0), device=home)
    if mesh.world_size() == 1:
        return local.T.cpu().numpy()
    return mesh.gather_positions(local, owners).T.cpu().numpy()


def evaluate_dataset(extractor, cfg, image_size, transform, batch_size=1):
    """Retrieval eval of one dataset (the reference's cirscore): database
    and query descriptors, ranks on the extractor's device, protocol mAPs.
    Returns (metrics, per-query APs, vecs (D, Ndb), qvecs (D, Nq))."""
    db_paths = [im_fname(cfg, i) for i in range(cfg["n"])]
    q_paths = [qim_fname(cfg, i) for i in range(cfg["nq"])]
    # one bbx per query: a query without one is not cropped, the others are
    bbxs = cfg.get("bbxs")
    if bbxs is None and "gnd" in cfg:
        bbxs = [tuple(g["bbx"]) if g.get("bbx") else None
                for g in (cfg["gnd"][i] for i in range(cfg["nq"]))]
    if bbxs is not None and all(b is None for b in bbxs):
        bbxs = None

    vecs = extract_vectors(extractor, db_paths, image_size, transform,
                           batch_size=batch_size)
    if q_paths == db_paths and bbxs is None:
        qvecs = vecs.copy()     # the queries are the database images
    else:
        qvecs = extract_vectors(extractor, q_paths, image_size, transform,
                                bbxs=bbxs, batch_size=batch_size)
    ranks = rank_descriptors(vecs, qvecs, device=extractor.device)
    metrics, aps = compute_map_protocols(cfg["dataset"], ranks.cpu().numpy(),
                                         cfg["gnd"])
    return metrics, aps, vecs, qvecs
