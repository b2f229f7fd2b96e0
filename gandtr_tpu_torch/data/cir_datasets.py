"""Tuple datasets of the GeM fine-tune (counterpart of
gandtr_tpu/data/cir_datasets.py; the reference's CirTuples and
CirDiverseAnchors).

Each epoch the miner picks the tuples [anchor, positive, negatives...];
an item is one tuple as padded uint8 images in a square bucket with each
image's valid (h, w), its loss labels and its augmentation gate. The
generator's elementwise transform (/255, normalize) runs on the device in
the step, so only uint8 crosses to the card; the JAX package's float host
pipeline is not ported.
"""
import os
import re

import numpy as np
from PIL import Image

from gandtr_tpu_torch.data.datasets import imread
from gandtr_tpu_torch.data.mining import TuplesMiner, cid2filename
from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                metadata_name)
from gandtr_tpu_torch.utils.io import load_pickle, resolve_path


def imresize(img, imsize):
    """Longest-side LANCZOS thumbnail (cirtorch's datahelpers.imresize)."""
    img.thumbnail((int(imsize), int(imsize)), Image.LANCZOS)
    return img


def generator_safe_bucket(image_size):
    """The padded-bucket side of tuple batches: rounded up to a multiple of
    4, so the 2x-down / 2x-up ResNet generator maps the bucket onto itself
    (the reference feeds 362 and embeds the generator's 364 output)."""
    return -(-int(image_size) // 4) * 4


def load_u8_padded(path, image_size, bucket):
    """One image decoded, resized to `image_size` on its longest side and
    zero-padded into a (bucket, bucket, 3) uint8 array; returns (array,
    (h, w))."""
    arr = np.asarray(imresize(imread(path), image_size))
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    h, w = min(arr.shape[0], bucket), min(arr.shape[1], bucket)
    out = np.zeros((bucket, bucket, 3), np.uint8)
    out[:h, :w] = arr[:h, :w]
    return out, (h, w)


class TupleEpochDataset:
    """Mined tuples as padded uint8 buckets. An item is (imgs (S, B, B, 3)
    uint8, hws (S, 2) int32, labels (S,) float32, pass_mask (S,) bool)."""

    def __init__(self, db, images, image_size, miner, augment_ratio=0.25,
                 augment_label="anc"):
        self.db = db
        self.images = images
        self.image_size = int(image_size)
        self.pad_size = generator_safe_bucket(image_size)
        self.miner = miner
        self.augment_ratio = augment_ratio
        self.augment_label = augment_label
        self.extract_fn = None
        self.tuples = None
        self.tuple_labels = None

    def prepare_epoch(self):
        if self.extract_fn is None:
            raise RuntimeError("set extract_fn before training")
        qidxs, pidxs, nidxs, labels, stats = self.miner.create_epoch_tuples(
            self.extract_fn)
        self.tuples = list(zip(qidxs, pidxs, nidxs))
        self.tuple_labels = labels  # rows x tuples (may carry -easy/-hard)
        return stats

    def __len__(self):
        return len(self.tuples) if self.tuples else self.miner.qsize

    def _load_tuple_u8(self, idxs):
        """Padded uint8 crops (S, B, B, 3) and each image's valid (h, w)."""
        outs, hws = zip(*(load_u8_padded(self.images[i], self.image_size,
                                         self.pad_size) for i in idxs))
        return np.stack(outs), np.asarray(hws, np.int32)

    def __getitem__(self, i):
        q, p, negs = self.tuples[i]
        negs = list(negs)
        tuple_labels = [row[i] for row in self.tuple_labels]
        # first_neg (traindataset.py): "pos" makes the top-ranked negative a
        # positive of the loss; "exc" drops it from the tuple
        first = [0.0]
        if negs:
            if self.miner.first_neg == "pos":
                first = [1.0]
            elif self.miner.first_neg == "exc":
                negs = negs[1:]
                del tuple_labels[2]
                first = [0.0] if negs else []
        idxs = [q, p] + negs
        labels = np.asarray([-1.0, 1.0] + (first + [0.0] * (len(negs) - 1)
                                           if negs else []), np.float32)
        # the label gate is a regex match, as in the reference's wrapper
        pmask = np.asarray(
            [bool(re.match(self.augment_label, lbl)) and
             cir_hash_passthrough(metadata_name(self.images[idx]),
                                  self.augment_ratio)
             for idx, lbl in zip(idxs, tuple_labels)], bool)
        imgs_u8, hws = self._load_tuple_u8(idxs)
        return imgs_u8, hws, labels, pmask


def load_tuples_db(dataset_pkl, split, ims_root, dataset_name=None):
    """The split ({cids | ids, cluster, qidxs, pidxs}) of a
    retrieval-SfM-style training pkl and its image paths; without a pkl,
    data/train/<dataset_name>/<dataset_name>.pkl."""
    path = resolve_path(dataset_pkl) if dataset_pkl else None
    if path is None and dataset_name:
        path = resolve_path("data/train/%s/%s.pkl"
                            % (dataset_name, dataset_name))
    db = load_pickle(path)[split]
    root = resolve_path(ims_root or "")
    if root.endswith(".h5"):
        raise NotImplementedError("h5 image stores (%r) are not ported yet"
                                  % root)
    if "cids" in db:
        images = [cid2filename(cid, root) for cid in db["cids"]]
    else:
        images = [os.path.join(root, x) for x in db["ids"]]
    return db, images


def _count(value, default):
    """A query or pool size; the reference's `.inf` means no cap."""
    v = float(value if value is not None else default)
    return (1 << 62) if v == float("inf") else int(v)


def _swap_qp(db, params):
    if params.pop("swap_qp", False):
        db = dict(db)
        db["qidxs"], db["pidxs"] = db["pidxs"], db["qidxs"]
    return db


def _dataset(params, diverse):
    db, images = load_tuples_db(params.pop("dataset_pkl", None),
                                params.pop("split"),
                                params.pop("image_dir", ""),
                                params.pop("dataset", None))
    db = _swap_qp(db, params)
    image_size = params.pop("image_size")
    kw = {}
    if diverse:
        kw = {"qpool_size": _count(params.pop("qpool_size", None), 10000),
              "similar_exclude": float(params.pop("similar_exclude", 0.2)),
              "similar_include": float(params.pop("similar_include", 0.8)),
              "mark_easy": params.pop("mark_easy", None)}
    else:
        params.pop("qpool_size", None)
    miner = TuplesMiner(db, nnum=int(params.pop("neg_num", 5)),
                        qsize=_count(params.pop("query_size", None), 2000),
                        poolsize=_count(params.pop("pool_size", None), 22000),
                        shuffle=bool(params.pop("shuffle", True)),
                        first_neg=params.pop("first_neg", "neg"), **kw)
    if params:
        raise ValueError("unused %s params: %s" % (
            "CirDiverseAnchors" if diverse else "CirTuples", sorted(params)))
    return TupleEpochDataset(db, images, image_size, miner)


def cir_tuples_dataset(**params):
    """`CirTuples` (cirtorch_datasets.py): random-query hard-negative
    mining."""
    return _dataset(params, diverse=False)


def cir_diverse_anchors_dataset(**params):
    """`CirDiverseAnchors` (cirtorch_datasets.py): diverse-anchor
    mining."""
    return _dataset(params, diverse=True)
