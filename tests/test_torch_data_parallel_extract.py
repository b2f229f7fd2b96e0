"""The port's data-parallel extraction on the CPU (eval/retrieval.py,
scenarios/validate_stage.py, the fine-tune's mining extraction in
scenarios/finetune_build.py): over two gloo ranks (tests/
torch_dp_workers.py) each rank extracts its share of the images, every
N-th image for the eval and every N-th batch for mining, and the
descriptors gathered back in input order equal one process's bit for bit;
an extractor given two devices goes round-robin over them with the same
result. The eval runs the published chain (CLAHE, GeM-VGG16 at full
width) exact and bucketed, so the static and the masked CLAHE (K1's and
K4's plain versions here) both run on every rank."""
import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu_torch.eval.retrieval import (ShapeCachedExtractor,
                                             extract_vectors)
from gandtr_tpu_torch.scenarios.infer_stage import _load_network
from gandtr_tpu_torch.scenarios.validate_stage import build_eval
from test_torch_data_parallel_finetune import _params as finetune_params
from torch_dp_workers import finetune_step, spawn

torch.set_num_threads(1)

MODEL = {"architecture": "cirnet", "cir_architecture": "vgg16",
         "pooling": "gem", "local_whitening": False, "whitening": False}
IMNET = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
SHAPES = [(40, 52), (52, 40), (36, 36), (47, 30), (30, 47)]
IMAGE_SIZE = 48


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_photos")
    rs = np.random.RandomState(7)
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        p = str(root / ("p%d.jpg" % i))
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(p, quality=90)
        paths.append(p)
    return paths


def _eval_params(bucket):
    return {"network": {"model": dict(MODEL)},
            "data": {"image_size": IMAGE_SIZE, "shape_bucket": bucket,
                     "transforms": "pil2np | apply_clahe:1.0 | totensor | "
                                   "normalize", "mean_std": IMNET}}


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    return _load_network({"model": dict(MODEL)},
                         torch.device("cpu")).module.state_dict()


@pytest.fixture(scope="module")
def single(weights, photos):
    """One process's descriptors, exact (None) and bucketed (32)."""
    out = {}
    for bucket in (None, 32):
        setup = build_eval(_eval_params(bucket), torch.device("cpu"))
        setup["model"].module.load_state_dict(weights, strict=True)
        out[bucket] = (setup, extract_vectors(
            setup["extractor"], photos, IMAGE_SIZE, setup["transform"]))
    return out


def test_rank_sharded_eval_extraction_is_bit_for_bit(weights, photos,
                                                     single):
    """Rank r extracts images r, r+2, ... (3 and 2 of the 5): the gathered
    descriptors equal one process's bit for bit, exact and bucketed, on
    both ranks."""
    ranks = spawn("extract", params=[_eval_params(None), _eval_params(32)],
                  weights=weights, paths=photos, image_size=IMAGE_SIZE)
    for r in ranks:
        for got, bucket in zip(r["vecs"], (None, 32)):
            want = single[bucket][1]
            assert got.shape == want.shape == (512, len(photos))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bucket", [None, 32])
def test_round_robin_extraction_is_bit_for_bit(photos, single, bucket):
    """An extractor over two devices (both the CPU here) sends successive
    images to each in turn, as the JAX package's does: the descriptors are
    one device's."""
    setup, want = single[bucket]
    ex = ShapeCachedExtractor(setup["extractor"].forward,
                              shape_bucket=bucket, device="cpu",
                              devices=["cpu", "cpu"])
    got = extract_vectors(ex, photos, IMAGE_SIZE, setup["transform"])
    assert ex._rr == len(photos)
    np.testing.assert_array_equal(got, want)


def test_rank_sharded_mining_extraction_is_bit_for_bit(photos):
    """The fine-tune's mining extraction over two ranks in batches of 2:
    rank 0 runs batches 0 and 2, rank 1 batch 1, and the gathered
    descriptors equal one process's bit for bit (every batch is the same
    batch). The augment net's generator runs on the gated images."""
    db = {"cids": ["c%d" % i for i in range(len(photos))],
          "cluster": [0, 0, 1, 1, 2], "qidxs": [0, 2], "pidxs": [1, 3]}
    args = dict(batch=None, db=db, images=photos, extract_batch=2)
    ranks = spawn("finetune_step", params=finetune_params({"devices": 2}, 2),
                  **args)
    from gandtr_tpu_torch.scenarios import finetune_build
    saved = finetune_build.EXTRACT_BATCH
    try:
        one = finetune_step(finetune_params(True, 2), **args)
    finally:
        finetune_build.EXTRACT_BATCH = saved
    assert one["mined"].shape == (512, len(photos))
    for r in ranks:
        np.testing.assert_array_equal(r["mined"], one["mined"])
