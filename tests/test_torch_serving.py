"""The port's served paths as a whole, on the CPU, against the JAX package's
serving forward on the same weights: uint8 images -> LAB CLAHE -> normalize
-> GeM VGG16 at 3 scales -> (Lw) -> descriptor, and uint8 images ->
normalize -> ResNet generator -> uint8 images; then the HTTP server."""
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu import hub as jhub
from gandtr_tpu.learning.wrappers import CirtorchWhiten as JWhiten
from gandtr_tpu.serving.export import _export_forward
from gandtr_tpu_torch import hub as thub
from gandtr_tpu_torch.learning.wrappers import CirtorchWhiten as TWhiten
from gandtr_tpu_torch.serving.export import Servable
from gandtr_tpu_torch.serving.service import (BatchingService, encode_png,
                                              serve_http)
from gandtr_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

HW = (64, 80)


@pytest.fixture(scope="module")
def models():
    jm = jhub._embedding("vgg16", pretrained=False)
    tm = thub._embedding("vgg16", pretrained=False, device="cpu")
    tm.net.module.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, jm.variables)), strict=True)
    assert tm.meta["msp"] == jm.meta["msp"] == 3.0
    return jm, tm


def _images(n=2, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n,) + HW + (3,),
                                               dtype=np.uint8)


def _jax_served(jm, x):
    _, _, forward = _export_forward(jm, from_uint8=True, kind="embedding")
    # eager, so XLA's CPU jit does not contract the CLAHE lerp into FMAs
    # (which flips round-half-even ties against cv2)
    with jax.disable_jit():
        return np.asarray(forward(jnp.asarray(x)))


@pytest.mark.parametrize("with_lw", [False, True])
def test_served_descriptors_match_jax(models, with_lw):
    """Tolerance 1e-4 on unit-norm descriptors: TF32 plays no part (CPU,
    float32); what remains is float32 summation order in the convolutions
    and resizes, and a possible one-step flip of a pixel's uint8 lightness
    before CLAHE (tests/test_torch_clahe.py)."""
    jm, tm = models
    if with_lw:
        rng = np.random.RandomState(11)
        P = rng.randn(512, 512).astype(np.float32) / np.sqrt(512)
        m = rng.randn(512, 1).astype(np.float32) * 0.01
        # first in the list: its post runs after multiscale aggregation,
        # as in the hub's pretrained chain
        jm.net.wrappers_eval.insert(0, JWhiten(P=P, m=m))
        tm.net.wrappers_eval.insert(0, TWhiten(P=P, m=m, device="cpu"))
    try:
        x = _images()
        want = _jax_served(jm, x)
        got = Servable(tm, HW)(x)
    finally:
        if with_lw:
            jm.net.wrappers_eval.pop(0)
            tm.net.wrappers_eval.pop(0)
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _post(url, body, ctype="application/octet-stream"):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_http_predict_matches_direct_call(models):
    _, tm = models
    servable = Servable(tm, HW)
    server = serve_http({"gem": servable}, port=0, block=False, device="cpu",
                        max_wait_ms=200)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        health = _get(base + "/healthz")
        assert health["status"] == "ok" and health["device"] == "cpu"
        meta = _get(base + "/v1/models")["gem"]
        assert meta["kind"] == "embedding" and meta["image_hw"] == list(HW)
        assert meta["output_shape_per_item"] == [512]

        x = _images(3, seed=1)
        results = [None] * 3

        def call(i):
            buf = io.BytesIO()
            np.save(buf, x[i])
            results[i] = _post(base + "/v1/models/gem:predict",
                               buf.getvalue())["descriptor"]

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        # the batcher may group the requests otherwise than the direct call
        # does, and a convolution may then sum in another order
        np.testing.assert_allclose(np.asarray(results, np.float32),
                                   servable(x), atol=1e-6, rtol=0)
    finally:
        server.close()


def test_http_rejects_bad_requests(models):
    _, tm = models
    server = serve_http({"gem": Servable(tm, HW)}, port=0, block=False,
                        device="cpu")
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        buf = io.BytesIO()
        np.save(buf, np.zeros((4, 4), np.float32))
        for path, code in [("/v1/models/gem:predict", 400),
                           ("/v1/models/nope:predict", 404),
                           ("/v1/models/gem:search", 404)]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, buf.getvalue())
            assert e.value.code == code
    finally:
        server.close()


def test_hub_loads_local_checkpoint_and_lw(models, tmp_path):
    """pretrained=True reads a reference-layout file (flat dict with
    `model_state`) and an Lw pickle from local paths; URLs are refused."""
    import pickle
    _, tm = models
    state = {k: v.clone() for k, v in tm.net.module.state_dict().items()}
    ckpt = tmp_path / "embed.pth"
    torch.save({"type": "cirnet", "model_state": state}, ckpt)
    lw = {"P": np.eye(512, dtype=np.float32),
          "m": np.zeros((512, 1), np.float32)}
    with open(tmp_path / "lw.pkl", "wb") as f:
        pickle.dump(lw, f)
    m = thub.gem_vgg16_hedngan(pretrained=True, device="cpu",
                               checkpoint=str(ckpt),
                               whitening=str(tmp_path / "lw.pkl"))
    for k, v in m.net.module.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert [type(w).__name__ for w in m.net.wrappers_eval] == [
        "CirtorchWhiten", "CirMultiscaleAggregation"]
    with pytest.raises(ValueError, match="local file"):
        thub.gem_vgg16_hedngan(pretrained=True, device="cpu",
                               checkpoint=thub.BASE_URL + "x.pth")


GEN_HW = (32, 48)


@pytest.fixture(scope="module")
def generators():
    """The hub's cyclegan generator (9 blocks, full width) in both packages,
    on the JAX one's seeded weights."""
    jm = jhub._generator("instance", pretrained=False)
    tm = thub._generator("instance", pretrained=False, device="cpu")
    tm.net.module.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, jm.variables)), strict=True)
    return jm, tm


def test_served_generator_matches_jax(generators):
    """float32 on both sides; the uint8 images within one level: a float32
    summation-order difference can carry a value across a floor boundary."""
    jm, tm = generators
    x = np.random.RandomState(3).randint(0, 256, (2,) + GEN_HW + (3,),
                                         dtype=np.uint8)
    _, _, forward = _export_forward(jm, from_uint8=True, kind="generator")
    want = np.asarray(jax.jit(forward)(jnp.asarray(x)))
    servable = Servable(tm, GEN_HW)
    got = servable(x)
    assert servable.meta["kind"] == "generator"
    assert servable.meta["output_shape_per_item"] == list(GEN_HW) + [3]
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (2,) + GEN_HW + (3,)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_http_generator_answers_png(generators):
    """:predict on a generator answers image/png, which decodes to the
    direct call's uint8 image exactly (both run as a batch of one)."""
    from PIL import Image
    _, tm = generators
    servable = Servable(tm, GEN_HW)
    server = serve_http({"gen": servable}, port=0, block=False, device="cpu")
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        meta = _get(base + "/v1/models")["gen"]
        assert meta["kind"] == "generator"
        x = np.random.RandomState(4).randint(0, 256, (2,) + GEN_HW + (3,),
                                             dtype=np.uint8)
        for img in x:
            buf = io.BytesIO()
            np.save(buf, img)
            req = urllib.request.Request(
                base + "/v1/models/gen:predict", data=buf.getvalue(),
                method="POST",
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.headers["Content-Type"] == "image/png"
                body = r.read()
            want = servable(img[None])[0]
            assert body == encode_png(want)
            got = np.asarray(Image.open(io.BytesIO(body)))
            assert got.dtype == np.uint8 and got.shape == GEN_HW + (3,)
            np.testing.assert_array_equal(got, want)
        assert server.models["gen"].batcher.batches == 2
    finally:
        server.close()


def test_batching_service_under_contention():
    """Many threads submit at once: every caller gets its own row back."""
    calls = []

    def fn(x):
        calls.append(len(x))
        return x * 2

    svc = BatchingService(fn, max_batch=4, max_wait_ms=2.0)
    out = [None] * 32

    def submit(i):
        out[i] = svc.submit(np.full((3,), i, np.int64)).result(timeout=30)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    svc.close()
    assert not any(t.is_alive() for t in threads)
    assert [int(o[0]) for o in out] == [2 * i for i in range(32)]
    assert sum(calls) == 32 and max(calls) <= 4
    with pytest.raises(RuntimeError):
        svc.submit(np.zeros(3))
