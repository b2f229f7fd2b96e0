"""`:search` over HTTP (gandtr_tpu_torch/serving/service.py) on the CPU:
with an exact and a PQ index behind one embedding model, the answers
equal `index.query` on the descriptors the direct call gives; a bad k is
400, a model without an index or an unknown model 404. Also the masked,
aspect-preserving fit of a request, a float32-input model's host
preprocessing, and an artifact directory served by its path."""
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu_torch import hub
from gandtr_tpu_torch.data.transforms import initialize_transforms
from gandtr_tpu_torch.serving import (PQRetrievalIndex, RetrievalIndex,
                                      Servable, export_hub_model, serve_http)
from gandtr_tpu_torch.serving.service import _fit_to_artifact
from torch_serving_common import EMB_HW, GEN_HW, generator_pair, images

torch.set_num_threads(2)
CPU = ["cpu"]


@pytest.fixture(scope="module")
def served():
    """A GeM VGG16 (one scale: no eval wrappers, so it also takes a mask)
    with an exact and a PQ index over 300 seeded database rows plus the
    descriptors of 3 of the query images."""
    model = hub._embedding("vgg16", pretrained=False, multiscale=False,
                           device="cpu")
    servable = Servable(model, EMB_HW, batch_buckets=(1, 2))
    queries = images(3, EMB_HW, seed=11)
    direct = servable(queries)
    rng = np.random.RandomState(12)
    db = rng.randn(300, 512).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    rows = np.concatenate([db, direct], 0)
    names = ["db%03d" % i for i in range(300)] + ["q0", "q1", "q2"]
    exact = RetrievalIndex(512, devices=CPU)
    exact.add(names, rows)
    pq = PQRetrievalIndex(512, m=16, ksub=32, devices=CPU).fit(rows, iters=5)
    pq.add(names, rows)
    return model, servable, queries, direct, exact, pq


def _post(url, img, ctype="application/octet-stream"):
    if isinstance(img, bytes):
        body = img
    else:
        buf = io.BytesIO()
        np.save(buf, img)
        body = buf.getvalue()
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers["Content-Type"], r.read()


@pytest.mark.parametrize("kind", ["exact", "pq"])
def test_search_equals_direct_query(served, kind):
    _, servable, queries, direct, exact, pq = served
    index = exact if kind == "exact" else pq
    server = serve_http({"gem": servable}, port=0, block=False, device="cpu",
                        indices={"gem": index})
    try:
        base = "http://127.0.0.1:%d/v1/models/gem" % server.server_address[1]
        for i in range(3):
            _, body = _post(base + ":search?k=7", queries[i])
            got = json.loads(body)["results"]
            want = index.query(direct[i][None], k=7)[0]
            assert [r["name"] for r in got] == [n for n, _ in want]
            np.testing.assert_allclose([r["score"] for r in got],
                                       [s for _, s in want], atol=1e-6)
            if kind == "exact":   # the query image finds itself first
                assert got[0]["name"] == "q%d" % i
        _, body = _post(base + ":search", queries[0])   # k defaults to 10
        assert len(json.loads(body)["results"]) == 10
        _, body = _post(base + ":predict", queries[0])
        np.testing.assert_allclose(json.loads(body)["descriptor"], direct[0],
                                   atol=1e-6)
    finally:
        server.close()


def test_search_errors(served):
    _, servable, queries, _, exact, _ = served
    server = serve_http({"gem": servable, "plain": servable}, port=0,
                        block=False, device="cpu", indices={"gem": exact})
    try:
        base = "http://127.0.0.1:%d/v1/models/" % server.server_address[1]
        for path, code in [("gem:search?k=0", 400), ("gem:search?k=x", 400),
                           ("gem:search?k=-3", 400), ("plain:search", 404),
                           ("nope:search", 404), ("gem:searching", 404)]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, queries[0])
            assert e.value.code == code, path
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "gem:search", b"not an image", ctype="image/jpeg")
        assert e.value.code == 400
    finally:
        server.close()
    with pytest.raises(ValueError, match="unknown models"):
        serve_http({"gem": servable}, block=False, device="cpu",
                   indices={"other": exact})


def test_masked_fit_keeps_the_aspect(served):
    """A masked model fits a 40x120 photo to (48, 64) by scale 8/15: the
    scaled image top-left, edge-padded, its rectangle in the mask; the
    served descriptor is the direct call's on that pair."""
    model = served[0]
    masked = Servable(model, EMB_HW, batch_buckets=(1,), with_mask=True)
    photo = images(1, (40, 120), seed=13)[0]
    x, mask = _fit_to_artifact(photo, masked.meta)
    assert x.shape == EMB_HW + (3,) and mask.shape == EMB_HW
    assert mask[:21, :64].all() and not mask[21:].any()
    np.testing.assert_array_equal(x[21:], np.repeat(x[20:21], 27, 0))
    server = serve_http({"m": masked}, port=0, block=False, device="cpu")
    try:
        url = "http://127.0.0.1:%d/v1/models/m:predict" % \
            server.server_address[1]
        _, body = _post(url, photo)
        np.testing.assert_allclose(json.loads(body)["descriptor"],
                                   masked(x, masks=mask)[0], atol=1e-6)
    finally:
        server.close()


def test_float32_model_takes_host_preprocessing(served):
    """from_uint8=False: the server runs the model's own transform
    pipeline (CLAHE, normalize) on the host from the meta."""
    model = served[0]
    f32 = Servable(model, EMB_HW, batch_buckets=(1,), from_uint8=False)
    img = images(1, EMB_HW, seed=14)[0]
    tf = initialize_transforms(f32.meta["transforms"], f32.meta["mean_std"])
    want = f32(np.asarray(tf(Image.fromarray(img)), np.float32)[None])[0]
    server = serve_http({"f": f32}, port=0, block=False, device="cpu")
    try:
        url = "http://127.0.0.1:%d/v1/models/f:predict" % \
            server.server_address[1]
        _, body = _post(url, img)
        np.testing.assert_allclose(json.loads(body)["descriptor"], want,
                                   atol=1e-6)
    finally:
        server.close()


def test_artifact_directory_served_by_path(tmp_path):
    """serve_http loads an artifact directory given as a path; a generator
    artifact with float32 output answers a PNG quantized on the host."""
    _, gen = generator_pair()
    path = str(tmp_path / "gen")
    export_hub_model(gen, path, GEN_HW, batch_buckets=(1,), from_uint8=False)
    img = images(1, GEN_HW, seed=15)[0]
    server = serve_http({"gen": path}, port=0, block=False, device="cpu")
    try:
        url = "http://127.0.0.1:%d/v1/models/gen:predict" % \
            server.server_address[1]
        ctype, body = _post(url, img)
        assert ctype == "image/png"
        got = np.asarray(Image.open(io.BytesIO(body)))
        mem = Servable(gen, GEN_HW)(img)[0]    # quantized on the device
        assert got.shape == GEN_HW + (3,)
        assert np.abs(got.astype(int) - mem.astype(int)).max() <= 1
    finally:
        server.close()
    with pytest.raises(ValueError, match="embedding model"):
        serve_http({"gen": path}, block=False, device="cpu",
                   indices={"gen": RetrievalIndex(3, devices=CPU)})
