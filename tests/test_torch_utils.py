"""The port's last utilities against the JAX package's on the same inputs
(the cases of tests/test_utils.py): utils/stats.py (meters, stop watch,
the profiler trace), utils/io.py (hashes, the network-file layouts,
local loads; a URL raises), utils/imgtools.py (unnormalize in every
stretch mode and colorspace, grids), utils/modelviz.py (the parameter
table, the forward as a torch.fx DOT graph), utils/fs_api.py (the
JSON-POST ApiPath against a loopback http.server in this process) and
models/pretrained_urls.py (the tables, a caffe-style features file and a
whitening file loaded from local paths)."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from gandtr_tpu.utils import imgtools as jimg
from gandtr_tpu.utils import io as jio
from gandtr_tpu.utils import stats as jstats
from gandtr_tpu_torch.utils import imgtools, io, modelviz, stats
from test_utils import TestApiPath

torch.set_num_threads(1)


def test_average_meter_and_stopwatch(capsys):
    for mod in (stats, jstats):
        m = mod.AverageMeter(total=3, print_each=3, title="t")
        for v in (1.0, 2.0, 3.0):
            m.update(v)
        assert m.avg == 2.0 and m.count == 3
    err = capsys.readouterr().err
    assert err.count(">> t 3/3 avg 2.0000") == 2
    sw = stats.StopWatch()
    sw.lap("a")
    sw.lap("b")
    assert set(sw.laps) == {"a", "b"}
    logged = []
    sw.emit(lambda k, v, d: logged.append((k, d)))
    assert ("time/a", "scalar/time") in logged


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    with stats.trace("blk", str(tmp_path)):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(tmp_path / "blk.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with stats.trace("quick"):
        pass
    assert ">> trace[quick]:" in capsys.readouterr().err


def test_hashes_and_local_loads(tmp_path):
    p = tmp_path / "w-0123abcd.pth"
    torch.save({"a": torch.arange(3.0), "b": [torch.ones(2)]}, p)
    assert io.sha256_of(p) == jio.sha256_of(str(p))
    for name in ("w-0123abcd.pth", "w-0123abc.pth", "w.pth",
                 "x-deadbeefcafe.tar.gz", "net-abcdef12.PTH"):
        assert io.embedded_sha_prefix(name) == jio.embedded_sha_prefix(name)
    assert io.fetch(str(p)) == jio.fetch(str(p)) == str(p)
    assert io.fetch(str(p), sha256=io.sha256_of(p)) == str(p)
    with pytest.raises(IOError, match="sha256 mismatch"):
        io.fetch(str(p), sha256="0" * 64)
    got, want = io.load_torch_checkpoint(str(p)), \
        jio.load_torch_checkpoint(str(p))
    np.testing.assert_array_equal(got["a"], want["a"])
    np.testing.assert_array_equal(got["b"][0], want["b"][0])
    q = tmp_path / "plain.pkl"
    with open(q, "wb") as f:
        pickle.dump({"m": np.eye(2)}, f)
    np.testing.assert_array_equal(io.load_torch_checkpoint(str(q))["m"],
                                  np.eye(2))
    assert io.load_pickle(str(q))["m"].shape == (2, 2)
    for fn in (io.fetch, io.load_pickle, io.load_torch_checkpoint):
        with pytest.raises(ValueError, match="downloads nothing"):
            fn("https://example.invalid/w-0123abcd.pth")


@pytest.mark.parametrize("state", [
    {"type": "SingleNetwork", "frozen": False, "network_params": {},
     "model_state": {"w": 1}},
    {"type": "SingleNetwork", "model_state": {"w": 1},
     "_networks_included": {"teacher": {"model_state": {"v": 2}}}},
    {"net": {"model_state": {"w": 1},
             "_networks_included": {"aux": {"model_state": {}}}},
     "epoch": 3},
    {"w": 1, "v": 2}])
def test_normalize_network_checkpoint(state):
    import copy
    assert io.normalize_network_checkpoint(copy.deepcopy(state)) == \
        jio.normalize_network_checkpoint(copy.deepcopy(state))


@pytest.mark.parametrize("stretch", [None, "clip", "minmax"])
@pytest.mark.parametrize("colorspace", ["rgb", "lab", "luv", "lsh", "hsv"])
def test_unnormalize_matches_jax(stretch, colorspace):
    """Every stretch mode and the colorspace undo (within float32 rounding
    of the two colorspace implementations), the composite and one-channel
    forms."""
    rs = np.random.RandomState(0)
    ms = ([0.5, 0.4, 0.6], [0.5, 0.6, 0.4])
    for img in (rs.rand(8, 9, 3), rs.rand(8, 9, 5), rs.rand(8, 9, 1),
                rs.rand(8, 9)):
        img = ((img - 0.5) * 2.5).astype(np.float32)
        got = imgtools.unnormalize(img, ms, colorspace, stretch)
        want = jimg.unnormalize(img, ms, colorspace, stretch)
        assert got.shape == want.shape and got.shape[-1] == 3
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        np.testing.assert_array_equal(imgtools.to_uint8(got[:0]),
                                      jimg.to_uint8(want[:0]))
    x = rs.rand(6, 6, 3).astype(np.float32)
    np.testing.assert_allclose(imgtools.unnormalize((x - 0.5) / 0.5), x,
                               atol=1e-6)


def test_image_grid_matches_jax():
    rs = np.random.RandomState(1)
    imgs = [rs.rand(4, 5, 3).astype(np.float32) for _ in range(5)]
    for kw in ({}, {"cols": 3}, {"cols": 2, "pad": 0, "pad_value": 0.0}):
        np.testing.assert_array_equal(imgtools.image_grid(imgs, **kw),
                                      jimg.image_grid(imgs, **kw))
    assert imgtools.image_grid(imgs, cols=3).shape == (10, 3 * 7 - 2, 3)


def test_modelviz_graph_and_summary():
    """GeM-VGG16's forward as a DOT graph of its operators (13 convs), its
    parameter table totalling the JAX net's parameter count, and the
    truncation past max_nodes."""
    import jax
    import jax.numpy as jnp
    from gandtr_tpu.models.retrieval import GemRetrievalNet
    from gandtr_tpu.utils import modelviz as jviz
    from gandtr_tpu_torch.models import initialize_model
    net = initialize_model({"architecture": "cirnet",
                            "cir_architecture": "vgg16", "pooling": "gem",
                            "local_whitening": False, "whitening": False})
    dot = modelviz.architecture_graph(net.eval(), (1, 32, 32, 3))
    assert dot.startswith("digraph fx {") and dot.endswith("}")
    assert dot.count('label="convolution') == 13
    assert "output0" in dot and "input0 (1, 32, 32, 3)" in dot
    rows, total = modelviz.param_summary(net)
    var = jax.eval_shape(GemRetrievalNet(architecture="vgg16").init,
                         jax.random.PRNGKey(0),
                         jnp.zeros((1, 32, 32, 3), jnp.float32))
    assert total == sum(r[3] for r in rows) == jviz.param_summary(
        var["params"])[1]
    assert "gem_vgg16 (%d params)" % total in \
        modelviz.format_summary(net, "gem_vgg16")

    def fn(x):
        for _ in range(20):
            x = x * 2 + 1
        return x
    assert "more operators" in modelviz.fx_dot(fn, torch.ones(2),
                                               max_nodes=5)


class TestPortApiPath(TestApiPath):
    """tests/test_utils.py's round trip through the port's ApiPath, on the
    same loopback server (the JAX case runs again beside it)."""

    def test_port_round_trip(self, api_server, monkeypatch):
        from gandtr_tpu.utils import fs_api as jfs
        from gandtr_tpu_torch.utils import fs_api
        monkeypatch.setattr(jfs, "ApiPath", fs_api.ApiPath)
        monkeypatch.setattr(jfs, "fs_driver", fs_api.fs_driver)
        self.test_round_trip(api_server)

    def test_plain_url_and_local(self, tmp_path):
        from gandtr_tpu_torch.utils.fs_api import fs_driver
        assert fs_driver(str(tmp_path), "a", "b") == \
            os.path.join(str(tmp_path), "a", "b")
        with pytest.raises(ValueError, match="downloads nothing"):
            fs_driver("http://127.0.0.1:9/file.pth")


def test_pretrained_bootstrap(tmp_path):
    """init_network(pretrained=True) fills the backbone from a caffe-style
    features file ('0.weight' keys) as the JAX one does; load_whitening
    gives {'m', 'P'} float64; the tables are the JAX package's; a table
    key without a local file raises."""
    import jax.numpy as jnp
    from gandtr_tpu.models import pretrained_urls as jp
    from gandtr_tpu_torch.models import pretrained_urls as tp
    for table in ("FEATURES", "L_WHITENING", "R_WHITENING", "WHITENING"):
        assert getattr(tp, table) == getattr(jp, table)
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
           "M", 512, 512, 512]
    sd, idx, cin = {}, 0, 3
    rng = np.random.RandomState(0)
    for item in cfg:
        if item == "M":
            idx += 1
            continue
        sd["%d.weight" % idx] = torch.tensor(
            rng.randn(item, cin, 3, 3).astype(np.float32) * 0.02)
        sd["%d.bias" % idx] = torch.tensor(
            rng.randn(item).astype(np.float32) * 0.02)
        cin = item
        idx += 2
    path = str(tmp_path / "feats.pth")
    torch.save(sd, path)
    params = {"architecture": "cirnet", "cir_architecture": "vgg16",
              "pooling": "gem", "local_whitening": False, "whitening": False,
              "pretrained": True, "features_path": path}
    net = tp.init_network(dict(params))
    assert torch.equal(net.state_dict()["features.28.weight"],
                       sd["28.weight"])
    jmodel, jvar = jp.init_network(dict(params))
    x = np.random.RandomState(1).rand(1, 48, 40, 3).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(
        jvar, jnp.asarray(x))), rtol=0, atol=1e-5)
    wpath = str(tmp_path / "w.pth")
    torch.save({"m": np.zeros((512, 1)), "P": np.eye(512)}, wpath)
    w, jw = tp.load_whitening(wpath), jp.load_whitening(wpath)
    assert w["m"].dtype == w["P"].dtype == np.float64
    np.testing.assert_array_equal(w["P"], jw["P"])
    with pytest.raises(ValueError, match="downloads nothing"):
        tp.load_whitening("vgg16-gem")
    with pytest.raises(ValueError, match="downloads nothing"):
        tp.init_network(dict(params, features_path=None))


def test_mesh_arithmetic_matches_jax():
    """parallel/mesh.py's helpers without a process group: the spatial
    shard count as JAX's for every case, each rank's rows of a global
    batch (rank r takes [r B/N, (r+1) B/N)), the strided shares, world 1
    everywhere and init_distributed a no-op; a 2 x 2 spatial grid refused
    at world size 1."""
    from gandtr_tpu.parallel import mesh as jmesh
    from gandtr_tpu_torch.parallel import mesh
    for hw in (16, 32, 64, 96, 100, 256, 362):
        for down in (1, 4, 8, 16, 32):
            for halo in (1, 2, 3):
                assert mesh.max_spatial_shards(hw, down, halo) == \
                    jmesh.max_spatial_shards(hw, down, halo)
    x = torch.arange(12).reshape(6, 2)
    rows = [mesh.global_batch_array(x, r, 3) for r in range(3)]
    assert torch.equal(torch.cat(rows), x) and rows[1].tolist() == \
        [[4, 5], [6, 7]]
    assert mesh.local_rows(10, 1, 2) == (5, 10)
    assert mesh.strided_share(7, 1, 3) == [1, 4]
    assert (mesh.world_size(), mesh.rank(), mesh.is_writer()) == (1, 0, True)
    assert mesh.process_local_batch(5) == 5
    assert mesh.init_distributed() is None and not mesh.is_initialized()
    assert mesh.maybe_data_parallel(len, {"devices": 4}, 5) is len
    with pytest.raises(ValueError, match="world is 1"):
        mesh.spatial_mesh(2, 2)
