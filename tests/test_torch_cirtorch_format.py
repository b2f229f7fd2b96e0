"""The port's cirtorch-format stages (gandtr_tpu_torch/scenarios/
cirtorch_format_stage.py) against the JAX package's on the CPU: a
network of a checkpoint converted to the original cirtorch layout by each
package (the same keys and arrays), loaded back, used to embed seeded
photos (descriptors within 1e-4) and to learn Lw whitening."""
import os
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu.models.retrieval import GemRetrievalNet
from gandtr_tpu.scenarios import cirtorch_format_stage as jstage
from gandtr_tpu_torch.scenarios import cirtorch_format_stage as tstage
from gandtr_tpu_torch.utils.weights import from_jax_variables
from torch_serving_common import CIRNET, _shape_variables

torch.set_num_threads(2)
META = {"architecture": "vgg16", "pooling": "gem", "whitening": False,
        "local_whitening": False, "mean": [0.485, 0.456, 0.406],
        "std": [0.229, 0.224, 0.225]}


@pytest.fixture
def shape_only_init(monkeypatch):
    """The JAX loader's GemRetrievalNet.init by shape: every weight then
    comes from the file, and a real init of VGG16 compiles for seconds."""
    orig = GemRetrievalNet.init

    def init(self, rng, x, **kw):
        shapes = jax.eval_shape(lambda xx: orig(self, rng, xx, **kw), x)
        return jax.tree_util.tree_map(
            lambda v: jnp.zeros(v.shape, v.dtype), shapes)
    monkeypatch.setattr(GemRetrievalNet, "init", init)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One seeded GeM VGG16 as a JAX container checkpoint (msgpack,
    {"embed": variables}) and as the port's container ({"embed": network
    file}); 3 seeded 60 x 80 photos."""
    from gandtr_tpu.models import initialize_model as jinit
    root = tmp_path_factory.mktemp("cirtorch")
    variables = _shape_variables(jinit(CIRNET), (64, 64), 5)
    variables["params"]["gem_p"] = jnp.full((1,), 3.0)
    with open(root / "jax.msgpack", "wb") as f:
        f.write(flax.serialization.msgpack_serialize(
            {"embed": jax.tree_util.tree_map(np.asarray, variables)}))
    torch.save({"embed": {"model_state": from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables))}}, root / "port.pt")
    rng = np.random.RandomState(1)
    (root / "jpg").mkdir()
    names = []
    for i in range(3):
        Image.fromarray((rng.rand(60, 80, 3) * 255).astype(np.uint8)).save(
            root / "jpg" / ("i%d.jpg" % i))
        names.append("i%d.jpg" % i)
    return root, names


def test_convert_load_embed_match_jax(files, shape_only_init):
    root, names = files
    tout = tstage.convert_contained_net({
        "input_path": str(root / "port.pt"),
        "output_path": str(root / "out" / "port_cirtorch.pkl"),
        "meta": META}, ())[0]
    jout = jstage.convert_contained_net({
        "input_path": str(root / "jax.msgpack"),
        "output_path": str(root / "out" / "jax_cirtorch.pkl"),
        "meta": META}, ())[0]
    assert tout["keys"] == jout["keys"] == 27
    with open(tout["output_path"], "rb") as f:
        got = pickle.load(f)
    with open(jout["output_path"], "rb") as f:
        want = pickle.load(f)
    assert got["meta"] == want["meta"] == META
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for k, v in want["state_dict"].items():
        np.testing.assert_array_equal(got["state_dict"][k], v, err_msg=k)

    module, meta = tstage.load_cirtorch_network(jout["output_path"], "cpu")
    assert meta == META and not module.training
    params = {"network_path": jout["output_path"], "image_size": 64,
              "image_dir": str(root / "jpg"),
              "output": str(root / "out" / "vecs.pkl")}
    (tmeta,) = tstage.embed(dict(params), (names,), device="cpu")
    (jmeta,) = jstage.embed({**params, "output": None}, (names,))
    assert tmeta["count"] == 3 and tmeta["vecs"].shape == (512, 3)
    np.testing.assert_allclose(tmeta["vecs"], np.asarray(jmeta["vecs"]),
                               atol=1e-4, rtol=0)
    with open(root / "out" / "vecs.pkl", "rb") as f:
        assert pickle.load(f)["names"] == names
    with pytest.raises(KeyError, match="no_such_net"):
        tstage.convert_contained_net({
            "input_path": str(root / "port.pt"), "network": "no_such_net",
            "output_path": str(root / "out" / "x.pkl")}, ())


def test_learn_whitening_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    vecs = rng.randn(16, 60)
    vecs /= np.linalg.norm(vecs, axis=0, keepdims=True)
    params = {"qidxs": list(range(0, 40, 2)), "pidxs": list(range(1, 41, 2))}
    (tout,) = tstage.learn_whitening(
        {**params, "output": str(tmp_path / "lw.pkl")}, (vecs,))
    (jout,) = jstage.learn_whitening(dict(params), (vecs,))
    with open(tout["whitening"], "rb") as f:
        got = pickle.load(f)
    np.testing.assert_allclose(got["m"], jout["whitening"]["m"], atol=1e-10)
    np.testing.assert_allclose(got["P"], jout["whitening"]["P"], atol=1e-8)
    assert os.path.exists(tmp_path / "lw.pkl")
