"""The port's descriptor artifacts (gandtr_tpu_torch/serving/export.py) on
the CPU: a `torch.export`ed program a batch bucket, loaded, against the
in-memory `Servable` of the same model and against the JAX package's
artifact of the same weights; the masked and float32-input forms; the
refusals; and the custom ops that carry K1 and K3 through an export
(ops/library.py). The generator's artifacts, with bucket padding and
chunking: tests/test_torch_export_gen.py."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from gandtr_tpu.serving.export import (export_hub_model as jax_export,
                                       load_artifact as jax_load)
from gandtr_tpu_torch.serving.export import (Servable, export_hub_model,
                                             export_sharded_model,
                                             load_artifact)
from torch_serving_common import (EMB_HW, GEN_HW, embedding_pair,
                                  generator_pair, images)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emb(tmp_path_factory):
    """Both packages' GeM VGG16 (CLAHE, 3 scales) and their artifacts at
    EMB_HW, bucket 2."""
    jm, tm = embedding_pair()
    root = tmp_path_factory.mktemp("emb")
    meta = export_hub_model(tm, str(root / "port"), EMB_HW,
                            batch_buckets=(2,))
    jax_export(jm, str(root / "jax"), EMB_HW, batch_buckets=(2,))
    return jm, tm, str(root / "port"), str(root / "jax"), meta


def _graph_ops(path, bucket):
    ep = torch.export.load(os.path.join(path, "b%d.pt2" % bucket))
    return [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function"]


def test_descriptor_artifact_matches_in_memory(emb):
    """The loaded program runs the in-memory forward's ops on the same
    weights: equal within 1e-5 (in practice bit-equal); K1's op is one
    node of the program, its weights are inside."""
    _, tm, path, _, meta = emb
    assert sorted(os.listdir(path)) == ["b2.pt2", "meta.json"]
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f) == meta
    assert meta["kind"] == "embedding" and meta["device"] == "cpu"
    assert meta["output_shape_per_item"] == [512]
    assert meta["torch_version"] == torch.__version__
    ops = _graph_ops(path, 2)
    assert ops.count("gandtr.clahe_u8.default") == 1
    x = images(2, EMB_HW, seed=1)
    got = load_artifact(path, device="cpu")(x)
    want = Servable(tm, EMB_HW, batch_buckets=(2,))(x)
    assert got.shape == (2, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_descriptor_artifact_matches_jax_artifact(emb):
    """The port's artifact against the JAX package's on shared weights:
    1e-4 on unit-norm descriptors (float32 summation order, and a possible
    one-level flip of a lightness value that XLA's CPU jit rounds through
    a fused multiply-add in CLAHE)."""
    _, _, path, jpath, _ = emb
    x = images(2, EMB_HW, seed=2)
    got = load_artifact(path, device="cpu")(x)
    want = jax_load(jpath)(x)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _single_scale(tm):
    """The same GeM VGG16 without eval wrappers (one scale)."""
    from gandtr_tpu_torch.hub import HubModel
    from gandtr_tpu_torch.learning.network import WrappedNet
    net = WrappedNet(module=tm.net.module, meta=dict(tm.net.meta),
                     data_params=dict(tm.net.data_params))
    return HubModel(net, None, tm.device, meta={**tm.meta, "msp": 1.0})


def test_masked_float32_embedding_artifact(emb, tmp_path):
    """with_mask and from_uint8=False (the JAX test's emb_artifact): the
    program takes the normalized float32 batch and a mask, and equals the
    in-memory forward; a default mask is all ones; half a mask changes the
    descriptor; a 2-D mask serves one image."""
    tm = _single_scale(emb[1])
    path = str(tmp_path / "masked")
    meta = export_hub_model(tm, path, EMB_HW, batch_buckets=(2,),
                            from_uint8=False, with_mask=True)
    assert meta["input_dtype"] == "float32" and meta["with_mask"]
    art = load_artifact(path, device="cpu")
    mem = Servable(tm, EMB_HW, batch_buckets=(2,), from_uint8=False,
                   with_mask=True)
    x = np.random.RandomState(6).rand(2, *EMB_HW, 3).astype(np.float32)
    mask = np.ones((2,) + EMB_HW, np.float32)
    mask[1, 30:] = 0.0
    got = art(x, masks=mask)
    np.testing.assert_allclose(got, mem(x, masks=mask), atol=1e-5, rtol=0)
    np.testing.assert_allclose(art(x), art(x, masks=np.ones_like(mask)),
                               atol=0, rtol=0)
    assert np.abs(got[1] - art(x)[1]).max() > 1e-3
    assert art(x[0], masks=mask[0]).shape == (1, 512)
    with pytest.raises(ValueError, match="input must be float32"):
        art(images(1, EMB_HW))


def test_refusals(emb, tmp_path):
    jm, tm, path, jpath, _ = emb
    plain = _single_scale(tm)
    gen_tm = generator_pair()[1]
    with pytest.raises(ValueError, match="only applies to embedding"):
        export_hub_model(gen_tm, str(tmp_path / "a"), GEN_HW, with_mask=True)
    with pytest.raises(ValueError, match="wrapper-free"):
        export_hub_model(tm, str(tmp_path / "b"), EMB_HW, with_mask=True)
    plain.net.data_params = {"transforms": "pil2np | totensor | tolab | "
                             "normalize", "mean_std": [[0.5] * 3] * 2}
    with pytest.raises(ValueError, match="device-splittable"):
        export_hub_model(plain, str(tmp_path / "c"), EMB_HW)
    with pytest.raises(ValueError, match="platforms"):
        export_hub_model(gen_tm, str(tmp_path / "d"), GEN_HW,
                         platforms=["tpu"])
    # once refused, the sharded export now writes its artifact
    # (tests/test_torch_export_sharded.py runs it)
    meta = export_sharded_model(_single_scale(tm), str(tmp_path / "e"),
                                EMB_HW, 4)
    assert meta["sharded"] == {"n_devices": 4, "axis": "data",
                               "batch_per_device": 1}
    assert sorted(os.listdir(tmp_path / "e")) == ["b1.pt2", "meta.json"]
    # a JAX artifact (b<N>.jaxexp) is refused with a clear message
    with pytest.raises(ValueError, match="JAX package"):
        load_artifact(jpath, device="cpu")
    # an artifact exported for another device type
    other = str(tmp_path / "cuda_art")
    shutil.copytree(path, other)
    with open(os.path.join(other, "meta.json")) as f:
        meta = json.load(f)
    meta["device"] = "cuda"
    with open(os.path.join(other, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="exported for cuda"):
        load_artifact(other, device="cpu")
    art = load_artifact(path, device="cpu")
    with pytest.raises(ValueError, match="without mask"):
        art(images(1, EMB_HW), masks=np.ones((1,) + EMB_HW, np.float32))
    with pytest.raises(ValueError, match="input must be uint8"):
        art(images(1, (32, 32)))
    if not torch.cuda.is_available():
        # the default device is cuda, and there is none here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_artifact(path)


def test_custom_op_fake_impls_and_registration():
    """The fake implementations give the outputs' shapes and dtypes (what
    torch.export records), and opcheck holds each op's registrations
    against each other on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from gandtr_tpu_torch.ops import library
    with FakeTensorMode():
        img = torch.empty((3, 37, 53), dtype=torch.uint8)
        out = torch.ops.gandtr.clahe_u8(img, 1.0, 8, 8)
        assert out.shape == (3, 37, 53) and out.dtype == torch.uint8
        x = torch.empty((2, 6, 7, 16), dtype=torch.float32)
        w = torch.empty((3, 3, 16, 16), dtype=torch.bfloat16)
        b = torch.empty((16,), dtype=torch.bfloat16)
        y = torch.ops.gandtr.fused_resblock(x, w, b, w, b, 1e-5)
        assert y.shape == (2, 6, 7, 16) and y.dtype == torch.bfloat16
    rng = np.random.RandomState(7)
    img = torch.from_numpy(rng.randint(0, 256, (2, 19, 23), dtype=np.uint8))
    torch.library.opcheck(library.clahe_u8, (img, 1.0, 4, 4))
    x = torch.from_numpy(rng.randn(1, 5, 6, 16).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.randn(3, 3, 16, 16).astype(np.float32) * 0.1
                         ).to(torch.bfloat16)
    b = torch.zeros(16, dtype=torch.bfloat16)
    torch.library.opcheck(library.fused_resblock, (x, w, b, w, b, 1e-5))
