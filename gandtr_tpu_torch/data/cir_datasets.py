"""Tuple datasets of the GeM fine-tune and the eval image list
(counterpart of gandtr_tpu/data/cir_datasets.py; the reference's
CirTuples, CirDiverseAnchors and CirImageList).

Each epoch the miner picks the tuples [anchor, positive, negatives...];
an item is one tuple as padded uint8 images in a square bucket with each
image's valid (h, w), its loss labels and its augmentation gate. The
generator's elementwise transform (/255, normalize) runs on the device in
the step, so only uint8 crosses to the card; the JAX package's float host
pipeline is not ported (a dataset label's `transform` is not applied to
tuples: its elementwise part runs in the step).

An image root ending in `.h5` is an h5 image store (the reference's
`flat_by_cid` layout, checked before use): its images are read lazily as
`store.h5#<key>` paths (data/datasets.py::imread), keyed by cid for the
tuple datasets and by the image's basename for `CirImageListDataset`.
"""
import os
import re

import numpy as np
from PIL import Image

from gandtr_tpu_torch.data.datasets import imread, path_join
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

    loader_params = {"drop_last": True}

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
        # an h5 store keyed by cid: lazy `store.h5#cid` paths (the
        # reference decodes the whole store up front)
        _check_h5_store(root)
        images = ["%s#%s" % (root, cid) for cid in db["cids"]]
    elif "cids" in db:
        images = [cid2filename(cid, root) for cid in db["cids"]]
    else:
        images = [os.path.join(root, x) for x in db["ids"]]
    return db, images


def _check_h5_store(path):
    """The store's layout, as the reference asserts it before use
    (traindataset.py:69, genericdataset.py:48): `storage_type` is
    "flat_by_cid" (a str, bytes, or the reference's array form)."""
    import h5py
    with h5py.File(path, "r") as f:
        storage = f.attrs["storage_type"]
        if isinstance(storage, bytes):
            storage = storage.decode("utf8")
        elif not isinstance(storage, str):
            storage = np.asarray(storage).tobytes().decode("utf8")
        if storage != "flat_by_cid":
            raise ValueError("h5 store %s has storage_type %r, not "
                             "'flat_by_cid'" % (path, storage))


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


def cir_tuples_dataset(data=(), transform=None, **params):
    """`CirTuples` (cirtorch_datasets.py): random-query hard-negative
    mining. `data` must be empty (the pickle names the images)."""
    if data:
        raise ValueError("CirTuples takes its images from its pickle")
    return _dataset(params, diverse=False)


def cir_diverse_anchors_dataset(data=(), transform=None, **params):
    """`CirDiverseAnchors` (cirtorch_datasets.py): diverse-anchor
    mining."""
    if data:
        raise ValueError("CirDiverseAnchors takes its images from its pickle")
    return _dataset(params, diverse=True)


class CirImageListDataset:
    """`CirImageList` (cirtorch_datasets.py:33-50 with ImagesFromList): a
    list of images (with bbxs, and labels when `image_labels`), each
    decoded, cropped to its bbx, resized by its longest side and
    transformed; `ignore_errors` gives {} for an image that fails to load.
    With `load_images_with_bbx` the queries are pre-cropped files named
    `base.x1_y1_x2_y2.ext`. An `image_dir` ending in `.h5` is a store keyed
    by each image's basename."""

    loader_params = {}

    def __init__(self, data, transform, image_dir="", image_size=None,
                 image_labels=False, ignore_errors=False,
                 load_images_with_bbx=False, **params):
        if params:
            raise ValueError("unused CirImageList params: %s"
                             % sorted(params))
        if image_labels:
            *data, self.labels = data
        else:
            self.labels = None
        self.images, self.bbxs = (data[0], None) if len(data) == 1 \
            else data[:2]
        image_dir = resolve_path(image_dir)
        is_h5 = image_dir.endswith(".h5")
        if not is_h5:
            # the reference joins each name with the directory by
            # path_join before ImagesFromList: the '*' extension rules and
            # the default .jpg apply, and the bbx renaming works on the
            # joined names
            self.images = [path_join(image_dir, img) for img in self.images]
            image_dir = ""
        if load_images_with_bbx and self.bbxs:
            # the +1e-10 gives the reference's rounding of half-integer
            # coordinates
            self.images = [self._bbx_filename(img, bbx) if bbx else img
                           for img, bbx in zip(self.images, self.bbxs)]
            self.bbxs = None
        if is_h5:
            _check_h5_store(image_dir)
            self.images = ["%s#%s" % (image_dir, img.rsplit("/", 1)[-1])
                           for img in self.images]
            image_dir = ""
        self.image_dir = image_dir
        self.image_size = image_size
        self.transform = transform
        self.ignore_errors = ignore_errors

    @staticmethod
    def _bbx_filename(image, bbx):
        dirpath, fname = image.rsplit("/", 1) if "/" in image \
            else (None, image)
        basename, ext = fname.split(".", 1) if "." in fname \
            else (fname, None)
        out = "%s.%d_%d_%d_%d" % (
            (basename,) + tuple(round(x + 1e-10) for x in bbx))
        if ext:
            out = "%s.%s" % (out, ext)
        if dirpath:
            out = "%s/%s" % (dirpath, out)
        return out

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        # a plain join (ImagesFromList's), no extension rules
        name = self.images[i]
        path = os.path.join(self.image_dir, name) if self.image_dir else name
        try:
            img = imread(path)
        except Exception:
            if self.ignore_errors:
                return {}
            raise
        imfullsize = max(img.size)
        cropped = self.bbxs is not None and self.bbxs[i]
        if cropped:
            img = img.crop(self.bbxs[i])
        if self.image_size is not None:
            scale = max(img.size) / imfullsize if cropped else 1.0
            img = imresize(img, self.image_size * scale)
        if self.transform:
            img = self.transform(img)
        return img
