"""The port's native image decoder (gandtr_tpu_torch/native/: its own copy
of loader.cc, built with g++ at first use into the ignored _build/)
against PIL and against the JAX package's native decoder: every case of
tests/test_native_loader.py through the port's bindings and its
`data.datasets.imread`, `decode(..., scale_longest)` byte-equal to
`gandtr_tpu.native.decode` at the same scale, the served decode
(serving/service.py) with the native path on and off, and the build
itself (the library under _build/, keyed on the source)."""
import threading

import numpy as np
import pytest
from PIL import Image

from gandtr_tpu import native as jax_native
from gandtr_tpu_torch import native
from gandtr_tpu_torch.data import datasets
from gandtr_tpu_torch.serving import service
from test_native_loader import _img

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason="native loader did not build: %r" % (native.build_error(),))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """tests/test_native_loader.py's images: three JPEGs (qualities and
    subsamplings), an RGB PNG, a gray JPEG, a palette PNG, an RGBA PNG."""
    d = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w, q, sub) in enumerate(
            [(480, 640, 95, 0), (480, 640, 75, 2), (333, 517, 85, 1)]):
        p = str(d / ("j%d.jpg" % i))
        Image.fromarray(_img(rng, h, w)).save(p, quality=q, subsampling=sub)
        paths.append(p)
    p = str(d / "rgb.png")
    Image.fromarray(_img(rng, 240, 320)).save(p)
    paths.append(p)
    p = str(d / "gray.jpg")
    Image.fromarray(_img(rng, 100, 150)[:, :, 0]).save(p)
    paths.append(p)
    p = str(d / "pal.png")
    Image.fromarray(_img(rng, 100, 150)).convert("P").save(p)
    paths.append(p)
    p = str(d / "rgba.png")
    rgba = np.dstack([_img(rng, 80, 90), np.full((80, 90), 200, np.uint8)])
    Image.fromarray(rgba, "RGBA").save(p)
    paths.append(p)
    return paths


def _pil(p):
    return np.asarray(Image.open(p).convert("RGB"))


def test_built_from_the_ports_source():
    """The library is the port's build of its own loader.cc, under
    gandtr_tpu_torch/_build/, keyed on the source's hash."""
    so = native.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "gandtr_tpu_torch"
    assert native.SOURCE.parent.parent.name == "gandtr_tpu_torch"
    assert native.build_error() is None


def test_bit_exact_vs_pil(images):
    for p in images:
        arr = native.decode(p)
        assert arr is not None, p
        np.testing.assert_array_equal(arr, _pil(p), err_msg=p)


@pytest.mark.parametrize("scale", [0, 200, 300, 1024])
def test_equals_the_jax_native_decode(images, tmp_path, scale):
    """Byte-equal to the JAX package's native decode at the same
    scale_longest, the DCT-scaled decodes included."""
    rng = np.random.RandomState(1)
    big = str(tmp_path / "big.jpg")
    Image.fromarray(_img(rng, 1200, 1600)).save(big, quality=90)
    for p in images + [big]:
        got = native.decode(p, scale_longest=scale)
        want = jax_native.decode(p, scale_longest=scale)
        assert got is not None and want is not None, p
        np.testing.assert_array_equal(got, want, err_msg=p)


def test_batch_pool(images):
    with native.DecodePool(4) as pool:
        outs = pool.decode_batch(images)
    assert len(outs) == len(images)
    for out, p in zip(outs, images):
        np.testing.assert_array_equal(out, _pil(p), err_msg=p)


def test_dct_scaling(tmp_path):
    """scale_longest decodes at the smallest 1/8-granular DCT scale whose
    longest side still covers the target (Image.draft semantics)."""
    rng = np.random.RandomState(1)
    p = str(tmp_path / "big.jpg")
    Image.fromarray(_img(rng, 1200, 1600)).save(p, quality=90)
    arr = native.decode(p, scale_longest=1024)
    # 1600 * 6/8 = 1200 >= 1024; 1600 * 5/8 = 1000 < 1024
    assert (arr.shape[0], arr.shape[1]) == (900, 1200)
    half = native.decode(p, scale_longest=800)
    assert (half.shape[0], half.shape[1]) == (600, 800)
    im = Image.open(p)
    im.draft("RGB", (800, 600))
    ref = np.asarray(im)
    assert ref.shape == half.shape
    # scaled IDCTs may differ by 1 across libjpeg builds; the raster feeds
    # a resize: tests/test_native_loader.py's 2-level contract
    diff = np.abs(half.astype(int) - ref.astype(int))
    assert diff.max() <= 2 and (diff > 1).mean() < 0.01
    assert native.decode(p, scale_longest=4096).shape == (1200, 1600, 3)


def test_failure_modes(tmp_path):
    assert native.decode(str(tmp_path / "missing.jpg")) is None
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"\xff\xd8\xff" + b"garbage" * 10)
    assert native.decode(str(junk)) is None
    txt = tmp_path / "notimage.txt"
    txt.write_text("hello")
    assert native.decode(str(txt)) is None
    with native.DecodePool(2) as pool:
        assert pool.decode_batch([str(junk), str(txt)]) == [None, None]


def test_imread_routes_through_native(images, monkeypatch):
    """datasets.imread gives the same pixels with the native path on and
    off (the switch only chooses the decoder)."""
    a = np.asarray(datasets.imread(images[0]))
    monkeypatch.setattr(datasets, "_NATIVE_OK", False)
    b = np.asarray(datasets.imread(images[0]))
    np.testing.assert_array_equal(a, b)


def test_imread_non_rgb_mode_falls_back(images):
    gray = datasets.imread(images[0], mode="L")
    assert gray.mode == "L"
    ref = Image.open(images[0]).convert("L")
    np.testing.assert_array_equal(np.asarray(gray), np.asarray(ref))


def test_served_decode_native_and_pil(images, monkeypatch):
    """The served body decode: the native path and PIL's give the same
    pixels (GANDTR_TPU_NATIVE_LOADER=0 is PIL's)."""
    for p in images:
        with open(p, "rb") as f:
            body = f.read()
        a = service._decode_image_bytes(body, "image/jpeg")
        monkeypatch.setenv("GANDTR_TPU_NATIVE_LOADER", "0")
        b = service._decode_image_bytes(body, "image/jpeg")
        monkeypatch.delenv("GANDTR_TPU_NATIVE_LOADER")
        np.testing.assert_array_equal(a, b, err_msg=p)
        np.testing.assert_array_equal(a, _pil(p), err_msg=p)


def test_shared_pool_no_deadlock(images):
    """shared_pool() takes its own lock: DecodePool() takes the module's
    through the lazy load."""
    result = {}

    def use():
        result["arrs"] = native.shared_pool().decode_batch(images[:2])

    t = threading.Thread(target=use, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "shared_pool() deadlocked"
    assert all(a is not None for a in result["arrs"])
    assert native.shared_pool() is native.shared_pool()


def test_pool_concurrent_batches_and_close(images):
    """Concurrent decode_batch calls on one pool return correct results,
    and close() waits for the batches in flight; a double close from two
    threads destroys once."""
    pool = native.DecodePool(n_threads=2)
    refs = pool.decode_batch(images)
    errors = []

    def work():
        try:
            for _ in range(3):
                for o, r in zip(pool.decode_batch(images), refs):
                    np.testing.assert_array_equal(o, r)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    closers = [threading.Thread(target=pool.close) for _ in range(2)]
    for t in closers:
        t.start()
    for t in closers:
        t.join()
    with pytest.raises(RuntimeError, match="pool closed"):
        pool.decode_batch(images)
