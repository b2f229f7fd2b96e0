"""The port's h5 image stores and its three cir dataset labels
(gandtr_tpu_torch/data/datasets.py::imread and DATASET_LABELS,
data/cir_datasets.py) against the JAX package's, on a seeded store and a
seeded image tree: `store.h5#key` reads, `.h5` roots of a tuple pickle,
and the items of `CirTuples`, `CirDiverseAnchors` (mined with the same
descriptors) and `CirImageList` (bbx crops, labels, pre-cropped names,
ignore_errors, an h5 root), each equal to the JAX dataset's item."""
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from gandtr_tpu.data import cir_datasets as jcir
from gandtr_tpu.data import datasets as jds
from gandtr_tpu.data.transforms import initialize_transforms as j_tf
from gandtr_tpu_torch.data import cir_datasets as tcir
from gandtr_tpu_torch.data import datasets as tds
from gandtr_tpu_torch.data.mining import cid2filename
from gandtr_tpu_torch.data.transforms import initialize_transforms as t_tf

h5py = pytest.importorskip("h5py")

N = 10
SHAPES = [(40, 30), (30, 44), (36, 36), (50, 27), (28, 41)]
TF = ("pil2np | totensor | normalize", [[0.5] * 3, [0.5] * 3])


def _store(path, images, storage=np.void(b"flat_by_cid")):
    with h5py.File(path, "w") as f:
        f.attrs["storage_type"] = storage
        for key, arr in images.items():
            f[key] = arr


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """N seeded images as a cid tree and as an h5 store keyed by cid, and
    a tuple pickle over them (5 clusters of 2, query / positive pairs)."""
    root = tmp_path_factory.mktemp("cir")
    rs = np.random.RandomState(11)
    cids = ["%08x" % rs.randint(0, 1 << 30) for _ in range(N)]
    arrays = {cid: rs.randint(0, 256, SHAPES[i % len(SHAPES)] + (3,),
                              dtype=np.uint8) for i, cid in enumerate(cids)}
    ims = root / "ims"
    for cid, arr in arrays.items():
        path = cid2filename(cid, str(ims))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, format="PNG")
    _store(str(root / "ims.h5"), arrays)
    db = {"cids": cids, "cluster": [i // 2 for i in range(N)],
          "qidxs": [0, 2, 4, 6, 8], "pidxs": [1, 3, 5, 7, 9]}
    with open(root / "db.pkl", "wb") as f:
        pickle.dump({"train": db}, f)
    vecs = rs.randn(16, N).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=0)
    return {"root": root, "cids": cids, "arrays": arrays, "vecs": vecs}


def test_h5_imread_and_reopen(tree, tmp_path):
    """`store.h5#key` reads the key's array in both packages, through the
    cached handle; a store written again is reopened once."""
    store = str(tree["root"] / "ims.h5")
    for cid in tree["cids"][:3]:
        got = np.asarray(tds.imread("%s#%s" % (store, cid)))
        np.testing.assert_array_equal(got, tree["arrays"][cid])
        np.testing.assert_array_equal(
            got, np.asarray(jds.imread("%s#%s" % (store, cid))))
    # a store replaced on disk after its first read: the cached handle
    # lacks the new key, so it is reopened once
    other = str(tmp_path / "other.h5")
    arrs = [tree["arrays"][c] for c in tree["cids"][:2]]
    _store(other, {"a": arrs[0]})
    np.testing.assert_array_equal(np.asarray(tds.imread(other + "#a")),
                                  arrs[0])
    _store(other + ".new", {"a": arrs[0], "b": arrs[1]})
    os.replace(other + ".new", other)
    np.testing.assert_array_equal(np.asarray(tds.imread(other + "#b")),
                                  arrs[1])
    with pytest.raises(KeyError):
        tds.imread(other + "#missing")


@pytest.mark.parametrize("h5", [False, True])
def test_tuples_db_roots(tree, h5):
    """load_tuples_db over a cid tree and over an h5 root: the JAX
    package's paths and split."""
    root = str(tree["root"] / ("ims.h5" if h5 else "ims"))
    pkl = str(tree["root"] / "db.pkl")
    db, images = tcir.load_tuples_db(pkl, "train", root)
    jdb, jimages = jcir._load_db(pkl, "train", root)
    assert images == jimages and db == jdb
    if h5:
        assert images[0] == "%s#%s" % (root, tree["cids"][0])


def test_h5_store_layout_is_checked(tmp_path):
    bad = str(tmp_path / "bad.h5")
    _store(bad, {}, storage="by_folder")
    with pytest.raises(ValueError, match="flat_by_cid"):
        tcir.CirImageListDataset([["a.jpg"]], None, image_dir=bad)
    for storage in (b"flat_by_cid", "flat_by_cid"):
        good = str(tmp_path / "good.h5")
        _store(good, {}, storage=storage)
        tcir._check_h5_store(good)


@pytest.mark.parametrize("name,extra", [
    ("CirTuples", {}),
    ("CirDiverseAnchors", {"qpool_size": 4, "similar_exclude": 0.1,
                           "similar_include": 0.9})])
@pytest.mark.parametrize("h5", [False, True])
def test_mining_labels_match_jax(tree, name, extra, h5):
    """The label through each package's dataset factory, mined with the
    same descriptors: the same tuples, and each item (uint8 buckets, valid
    sizes, labels, gate) equal to the JAX dataset's uint8 item."""
    params = {"name": name, "dataset_pkl": str(tree["root"] / "db.pkl"),
              "split": "train", "image_size": 32, "neg_num": 2,
              "query_size": 3, "pool_size": 8,
              "image_dir": str(tree["root"] / ("ims.h5" if h5 else "ims")),
              **extra}
    loader = tds.initialize_dataset_loader(
        [], {"dataset": dict(params), "loader": {"batch_size": 1}})
    jparams = dict(params)
    jname = jparams.pop("name")
    jdataset = jds.DATASET_LABELS[jname]([], j_tf(*TF), **jparams)
    jdataset.device_preprocess = True
    dataset = loader.dataset
    dataset.miner.device = "cpu"   # the ranking's device (cuda by default)
    assert type(dataset).__name__ == "TupleEpochDataset"
    assert loader.drop_last

    def extract(idxs, label=None):
        return tree["vecs"][:, list(idxs)]
    for ds in (dataset, jdataset):
        ds.extract_fn = extract
        ds.prepare_epoch()
    assert len(dataset) == len(jdataset) == 3
    assert [(int(q), int(p), [int(n) for n in ns])
            for q, p, ns in dataset.tuples] == \
        [(int(q), int(p), [int(n) for n in ns])
         for q, p, ns in jdataset.tuples]
    for i in range(len(dataset)):
        for got, want in zip(dataset[i], jdataset[i]):
            np.testing.assert_array_equal(got, np.asarray(want))


def _image_list(pkg, data, transform, **kw):
    cls = (tcir.CirImageListDataset if pkg == "port"
           else jcir.CirImageListDataset)
    return cls(data, transform, **kw)


@pytest.mark.parametrize("transform", [None, TF])
def test_image_list_matches_jax(tree, tmp_path, transform):
    """CirImageList built by the port's factory and the JAX one: bbx
    crops resized by their share of the full image's longest side, image
    labels, the pre-cropped-name mode, an h5 root keyed by basename, and
    ignore_errors; every item equal (the PIL image's pixels, or the
    transformed array)."""
    d = tmp_path / "list"
    d.mkdir()
    rs = np.random.RandomState(3)
    names, arrays = [], {}
    for i in range(4):
        arr = rs.randint(0, 256, (40 + 4 * i, 52 - 3 * i, 3), np.uint8)
        Image.fromarray(arr).save(d / ("im%d.png" % i))
        names.append("im%d.png" % i)
        arrays[names[-1]] = arr
    # the pre-cropped files of the bbx mode
    for name, bbx in (("im1.png", (2.5, 3, 30, 33)),):
        crop = Image.fromarray(arrays[name]).crop((3, 3, 30, 33))
        crop.save(d / "im1.3_3_30_33.png")
    bbxs = [None, (2.5, 3, 30, 33), (1, 2, 20, 25), None]
    store = str(tmp_path / "list.h5")
    _store(store, arrays)
    cases = [
        ([names], {"image_dir": str(d), "image_size": 24}),
        ([names, bbxs], {"image_dir": str(d), "image_size": 24}),
        ([names, bbxs, [0, 1, 0, 1]], {"image_dir": str(d),
                                       "image_labels": True}),
        ([names[:2], bbxs[:2]], {"image_dir": str(d),
                                 "load_images_with_bbx": True}),
        ([["x/" + n for n in names]], {"image_dir": store,
                                       "image_size": 30}),
        ([names + ["missing.png"]], {"image_dir": str(d),
                                     "ignore_errors": True}),
    ]
    for data, kw in cases:
        port = tds.DATASET_LABELS["CirImageList"](
            data, t_tf(*transform) if transform else None, **kw)
        want = _image_list("jax", data, j_tf(*transform) if transform
                           else None, **kw)
        assert len(port) == len(want)
        assert port.images == want.images
        assert port.labels == want.labels
        for i in range(len(port)):
            a, b = port[i], want[i]
            if isinstance(b, dict):
                assert a == b == {}
                continue
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=str((kw, i)))
