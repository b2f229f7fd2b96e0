"""The port's generator artifacts (gandtr_tpu_torch/serving/export.py) on
the CPU: the bf16 generator's program with one K3 op a block, byte-equal to
the in-memory `Servable`; bucket padding and chunking; the float32
generator within one level of the JAX package's serving forward on the
same weights; the float32-output form."""
import os

import jax
import numpy as np
import pytest
import torch

from gandtr_tpu.serving.export import _export_forward as jax_forward
from gandtr_tpu_torch.serving.export import (Servable, export_hub_model,
                                             load_artifact)
from torch_serving_common import GEN_HW, generator_pair, images

torch.set_num_threads(2)


def _graph_ops(path, bucket):
    ep = torch.export.load(os.path.join(path, "b%d.pt2" % bucket))
    return [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function"]


@pytest.fixture(scope="module")
def gen(tmp_path_factory):
    jm, tm = generator_pair(compute_dtype=torch.bfloat16)
    path = str(tmp_path_factory.mktemp("gen") / "bf16")
    meta = export_hub_model(tm, path, GEN_HW, batch_buckets=(2, 3))
    return jm, tm, path, meta


def test_generator_artifact_byte_equal_and_k3_in_graph(gen):
    """The bf16 generator's artifact: one K3 op a block in the program,
    uint8 output byte-equal to the in-memory path."""
    _, tm, path, meta = gen
    assert meta["kind"] == "generator"
    assert meta["output_shape_per_item"] == list(GEN_HW) + [3]
    assert _graph_ops(path, 2).count("gandtr.fused_resblock.default") == 2
    x = images(3, GEN_HW, seed=4)
    got = load_artifact(path, device="cpu")(x)
    want = Servable(tm, GEN_HW, batch_buckets=(2, 3))(x)
    assert got.dtype == np.uint8 and got.shape == (3,) + GEN_HW + (3,)
    np.testing.assert_array_equal(got, want)


def test_float32_generator_artifact_within_one_level_of_jax(tmp_path):
    """The float32 generator (no K3) against JAX's serving forward on the
    same weights: uint8 within one level (a float32 summation-order
    difference can carry a value across a floor boundary)."""
    jm, tm = generator_pair()
    export_hub_model(tm, str(tmp_path / "f32"), GEN_HW, batch_buckets=(2,))
    x = images(2, GEN_HW, seed=5)
    got = load_artifact(str(tmp_path / "f32"), device="cpu")(x)
    _, _, forward = jax_forward(jm, True, "generator")
    want = np.asarray(jax.jit(forward)(jax.numpy.asarray(x)))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_bucket_pad_and_chunk_exact(gen):
    """1 image pads to bucket 2 (edge rows); 4 images are a chunk of 3 and
    one of 1, padded to 2: each output equals the same image run in a full
    bucket, byte for byte."""
    _, _, path, _ = gen
    art = load_artifact(path, device="cpu")
    x = images(4, GEN_HW, seed=3)
    four = art(x)
    assert four.shape == (4,) + GEN_HW + (3,)
    np.testing.assert_array_equal(four[:3], art(x[:3]))
    np.testing.assert_array_equal(four[3:], art(np.stack([x[3], x[3]]))[:1])
    one = art(x[0])                       # (H, W, 3): a batch of one
    np.testing.assert_array_equal(one[0], four[0])
    assert sorted(art._programs) == [2, 3]


def test_float32_generator_artifact_within_one_level_of_jax(tmp_path):
    """The float32 generator (no K3) against JAX's serving forward on the
    same weights: uint8 within one level (a float32 summation-order
    difference can carry a value across a floor boundary). With
    from_uint8=False the program answers the normalized float32 image."""
    jm, tm = generator_pair()
    export_hub_model(tm, str(tmp_path / "f32"), GEN_HW, batch_buckets=(2,))
    x = images(2, GEN_HW, seed=5)
    got = load_artifact(str(tmp_path / "f32"), device="cpu")(x)
    _, _, forward = jax_forward(jm, True, "generator")
    want = np.asarray(jax.jit(forward)(jax.numpy.asarray(x)))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    meta = export_hub_model(tm, str(tmp_path / "float_in"), GEN_HW,
                            batch_buckets=(2,), from_uint8=False)
    assert meta["input_dtype"] == "float32"
    xf = (x.astype(np.float32) / 255.0 - 0.5) / 0.5
    out = load_artifact(str(tmp_path / "float_in"), device="cpu")(xf)
    assert out.dtype == np.float32 and out.shape == (2,) + GEN_HW + (3,)
    np.testing.assert_allclose(out, Servable(tm, GEN_HW, from_uint8=False)(xf),
                               atol=1e-6, rtol=0)
