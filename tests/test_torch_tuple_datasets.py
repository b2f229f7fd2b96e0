"""The port's ImageList, RandomImageTuple and PregeneratedImageTuple
datasets (gandtr_tpu_torch/data/datasets.py) against the JAX package's,
on the CPU.

- The tuples each epoch draws, over 3 epochs, for every form of the
  index DSL (an int, a negative int, "any", "different", a range with a
  raw negative start), from a dict and from a pickle read through the
  file readers: identical. RandomImageTuple draws from numpy's global RNG
  as the training loop seeds it; PregeneratedImageTuple once, from
  `random.Random(0)`.
- Batches through each package's Loader with a random chain (the JAX
  loader sequential, the port's on 3 threads with its planned draws):
  bit-equal.
"""
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu.data import datasets as jD
from gandtr_tpu.data import transforms as jT
from gandtr_tpu_torch.data import datasets as tD
from gandtr_tpu_torch.data import transforms as tT

torch.set_num_threads(1)

MS = [[0.5] * 3, [0.5] * 3]


@pytest.fixture(scope="module")
def tuples(tmp_path_factory):
    """8 rows of 5 candidate names (seeded JPEGs of a few shapes) under
    <root>/ims, and the rows as a pickle."""
    root = tmp_path_factory.mktemp("tuples")
    rs = np.random.RandomState(0)
    os.makedirs(root / "ims")
    rows = []
    for r in range(8):
        row = []
        for c in range(5):
            name = "r%dc%d" % (r, c)
            h, w = (30 + 3 * c, 34 + 2 * r)
            Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)) \
                .save(root / "ims" / (name + ".jpg"), quality=90)
            row.append(name)
        rows.append(row)
    with open(root / "tuples.pkl", "wb") as f:
        pickle.dump({"train": rows, "val": rows[:2]}, f)
    return root, rows


IDX = ["0_any", "any_different", "1_-1", "different_different_different",
       "any", [[1, 4], "any"], [[-2, None], 0], [0, [None, 3], "different"]]


def _epochs(module, cls, dataset, root, idx, n=3):
    ds = cls([], None, dataset, "train", str(root / "ims"), idx)
    out = []
    for epoch in range(n):
        np.random.seed(10 + epoch)
        ds.prepare_epoch()
        out.append([list(x) for x in ds.epoch_images])
    return out


@pytest.mark.parametrize("idx", IDX, ids=str)
@pytest.mark.parametrize("source", ["dict", "pkl"])
def test_epoch_tuples_equal_jax(tuples, idx, source):
    root, rows = tuples
    dataset = {"train": rows} if source == "dict" \
        else str(root / "tuples.pkl")
    for name in ("RandomImageTuple", "PregeneratedImageTuple"):
        want = _epochs(jD, jD.DATASET_LABELS[name], dataset, root, idx)
        got = _epochs(tD, tD.DATASET_LABELS[name], dataset, root, idx)
        assert got == want
        assert len(got[0]) == len(rows)
        # ints pick the same candidates every epoch
        if name == "PregeneratedImageTuple" or idx == "1_-1":
            assert got[0] == got[1] == got[2]
        else:
            assert got[0] != got[1]


def test_bad_index_raises_in_both(tuples):
    root, rows = tuples
    for module in (jD, tD):
        with pytest.raises((AssertionError, IndexError)):
            module.RandomImageTupleDataset(
                [], None, {"train": rows}, "train", str(root / "ims"),
                "0_7").prepare_epoch()


def _batches(module, T, ds_name, root, rows, workers, epochs=2):
    tf = T.initialize_transforms(
        "pil2np | random_crop:20 | mirror | gaussian_noise:0.05 | "
        "totensor | normalize", MS)
    ds = module.DATASET_LABELS[ds_name](
        [], tf, {"train": rows}, "train", str(root / "ims"), "0_different")
    loader = (module.Loader(ds, batch_size=3, shuffle=True, seed=2,
                            num_workers=workers))
    out = []
    for epoch in range(epochs):
        T.seed_transforms(5 + epoch)
        np.random.seed(5 + epoch)
        ds.prepare_epoch()
        out.extend(list(b) for b in loader)
    return out


@pytest.mark.parametrize("ds_name", ["RandomImageTuple",
                                     "PregeneratedImageTuple"])
def test_loader_batches_equal_jax(tuples, ds_name):
    root, rows = tuples
    want = _batches(jD, jT, ds_name, root, rows, workers=0)
    got = _batches(tD, tT, ds_name, root, rows, workers=3)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert len(g) == len(w) == 2
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_image_list_items_equal_jax(tuples):
    root, rows = tuples
    data = [[r[0] for r in rows], [r[2] for r in rows]]
    tf = "pil2np | center_crop:20 | totensor | normalize"
    want = jD.ImageListDataset(data, jT.initialize_transforms(tf, MS),
                               str(root / "ims"))
    got = tD.ImageListDataset(data, tT.initialize_transforms(tf, MS),
                              str(root / "ims"))
    assert len(got) == len(want) == 8
    for i in range(len(want)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    one = tD.ImageListDataset(data[:1], None, str(root / "ims"))[3]
    assert len(one) == 1 and one[0].dtype == np.uint8


def test_loader_config_takes_the_tuple_datasets(tuples):
    """`initialize_dataset_loader` with a reference-style config: the
    relative pickle resolves under $GANDTR_ROOT, as the other paths."""
    root, rows = tuples
    os.environ["GANDTR_ROOT"] = str(root)
    try:
        loader = tD.initialize_dataset_loader([], {
            "dataset": {"name": "PregeneratedImageTuple",
                        "dataset": "tuples.pkl", "data_key": "val",
                        "image_dir": "ims", "idx": "2_3"},
            "loader": {"batch_size": 2, "num_workers": 0},
            "transforms": "pil2np | center_crop:30 | totensor",
            "mean_std": MS})
    finally:
        del os.environ["GANDTR_ROOT"]
    assert [len(t) for t in loader.dataset.epoch_images] == [2, 2]
    (a, b), = list(loader)
    assert a.shape == b.shape == (2, 30, 30, 3)
