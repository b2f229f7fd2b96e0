"""The port's build_index and export stages and infer_incrementally
(gandtr_tpu_torch/scenarios/) through its `run_target`, against the JAX
package's stages on the same seeded photos and checkpoint, on the CPU;
the stages' options and refusals; the file readers
(gandtr_tpu_torch/utils/file_readers.py) and `configdataset_tsv` against
the JAX package's.

The JAX nets are built by shape (`WrappedNet.init` patched to
`jax.eval_shape`): every weight then comes from the checkpoint, and a
real JAX init of VGG16 would compile for seconds."""
import gzip
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu.eval.retrieval import configdataset_tsv as j_tsv
from gandtr_tpu.learning import network as jnetwork
from gandtr_tpu.scenarios import run as jrun
from gandtr_tpu.scenarios.infer_stage import \
    infer_incrementally as j_incremental
from gandtr_tpu.serving import load_artifact as j_load_artifact
from gandtr_tpu.serving import pq as jpq
from gandtr_tpu.utils import file_readers as jfr
from gandtr_tpu_torch.eval.retrieval import configdataset_tsv
from gandtr_tpu_torch.scenarios import run
from gandtr_tpu_torch.scenarios.infer_stage import infer_incrementally
from gandtr_tpu_torch.serving import load_artifact, load_index
from gandtr_tpu_torch.serving.pq import PQRetrievalIndex
from gandtr_tpu_torch.utils import file_readers as tfr
from gandtr_tpu_torch.utils.weights import from_jax_variables
from torch_serving_common import CIRNET, EMBEDDING_DATA, _shape_variables

torch.set_num_threads(2)
N_PHOTOS = 7
SIDE = 64          # data.image_size: every photo becomes 48 x 64


def _patch_init(mp):
    orig = jnetwork.WrappedNet.init

    def init(self, rng, x, **kw):
        shapes = jax.eval_shape(lambda xx: orig(self, rng, xx, **kw), x)
        return jax.tree_util.tree_map(
            lambda v: jnp.zeros(v.shape, v.dtype), shapes)
    mp.setattr(jnetwork.WrappedNet, "init", init)


@pytest.fixture(autouse=True)
def _shape_only_jax_init(monkeypatch):
    _patch_init(monkeypatch)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seeded 60 x 80 JPEGs and a reference-layout .pth of a GeM VGG16
    (seeded weights, GeM p 3, the hub's CLAHE data params)."""
    from gandtr_tpu.models import initialize_model as jinit
    root = tmp_path_factory.mktemp("stage")
    photos = root / "jpg"
    photos.mkdir()
    rng = np.random.RandomState(0)
    names = []
    for i in range(N_PHOTOS):
        arr = (rng.rand(60, 80, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(photos / ("p%d.jpg" % i), quality=90)
        names.append("p%d.jpg" % i)
    variables = _shape_variables(jinit(CIRNET), (64, 64), 3)
    variables["params"]["gem_p"] = jnp.full((1,), 3.0)
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    torch.save({"model_state": state, "network_params": {
        "model": CIRNET, "runtime": {"data": EMBEDDING_DATA}}},
        root / "net.pth")
    return {"root": str(root), "photos": str(photos), "names": names,
            "ckpt": str(root / "net.pth")}


def _network(s):
    return {"path": s["ckpt"], "model": dict(CIRNET)}


def _data(s):
    return {"image_dir": s["photos"], "image_size": SIDE,
            **EMBEDDING_DATA}


def _build(s, path, **index):
    return {"t": {"1_index": {
        "__function__": "gandtr_tpu.stages.build_index",
        "network": _network(s), "data": _data(s),
        "index": {"path": path, "skip_if_exists": False, **index}}}}


@pytest.fixture(scope="module")
def built(setup):
    s = setup
    jpath = os.path.join(s["root"], "jax_index.npz")
    tpath = os.path.join(s["root"], "port_index.npz")
    with pytest.MonkeyPatch.context() as mp:   # before the autouse patch
        _patch_init(mp)
        jout = jrun.run_target(_build(s, jpath), "t", "s", s["names"])
    tout = run.run_target(_build(s, tpath), "t", "s", s["names"],
                          device="cpu")
    return jout["1_index"], tout["1_index"], jpath, tpath


def test_build_index_matches_jax(built, setup):
    """Names equal and rows within 1e-4 (float32 summation order, and a
    one-level lightness flip that XLA's CPU jit can give CLAHE)."""
    jmeta, tmeta, jpath, tpath = built
    assert tmeta == {"path": tpath, "count": N_PHOTOS, "failed": 0}
    assert jmeta["count"] == tmeta["count"]
    with np.load(jpath) as j, np.load(tpath) as t:
        assert list(t["names"]) == list(j["names"]) == setup["names"]
        assert t["vecs"].shape == (N_PHOTOS, 512)
        np.testing.assert_allclose(t["vecs"], j["vecs"], atol=1e-4, rtol=0)
        assert json.loads(str(t["meta"])) == {"dim": 512}
    index = load_index(tpath, devices=["cpu"])
    with np.load(tpath) as t:
        got = index.query(t["vecs"][2], k=3)[0]
    assert got[0][0] == "p2.jpg" and abs(got[0][1] - 1.0) < 1e-5


def test_skip_if_exists_and_refusals(built, setup):
    _, _, _, tpath = built
    s = setup
    scen = _build(s, tpath)
    scen["t"]["1_index"]["index"]["skip_if_exists"] = True
    out = run.run_target(scen, "t", "s", ["nothing.jpg"], device="cpu")
    assert out["1_index"] == {"path": tpath, "count": N_PHOTOS,
                              "status": "skipped"}
    for extra in ({"bogus": 1}, {"pq": {"m": 16, "mm": 2}}):
        path = os.path.join(s["root"], "x.npz")
        with pytest.raises(ValueError, match="Unused"):
            run.run_target(_build(s, path, **extra), "t", "s", s["names"],
                           device="cpu")
        with pytest.raises(AssertionError, match="Unused"):
            jrun.run_target(_build(s, path, **extra), "t", "s", s["names"])
    scen = _build(s, os.path.join(s["root"], "y.npz"))
    scen["t"]["1_index"]["extra"] = 1
    with pytest.raises(ValueError, match="Unused build_index"):
        run.run_target(scen, "t", "s", s["names"], device="cpu")


def test_pq_section(built, setup):
    """`pq:` with train_size, iters and opq_iters: the stage's index is the
    one JAX's PQRetrievalIndex makes from the same rows (its subsample of
    RandomState(0), then fit), codebooks within 1e-5, codes equal."""
    _, _, _, tpath = built
    s = setup
    path = os.path.join(s["root"], "pq_index.npz")
    pq_cfg = {"m": 16, "ksub": 4, "rerank": 3, "train_size": 5, "iters": 4,
              "opq_iters": 0}
    out = run.run_target(_build(s, path, pq=dict(pq_cfg)), "t", "s",
                         s["names"], device="cpu")
    assert out["1_index"]["count"] == N_PHOTOS
    with np.load(tpath) as t:
        rows = t["vecs"]
    j = jpq.PQRetrievalIndex(512, m=16, ksub=4, rerank=3)
    sel = np.random.RandomState(0).permutation(N_PHOTOS)[:5]
    j.fit(rows[sel], iters=4)
    j.add(s["names"], rows)
    got = load_index(path, devices=["cpu"])
    assert isinstance(got, PQRetrievalIndex) and got.rerank == 3
    np.testing.assert_allclose(got.codebooks, j.codebooks, atol=1e-5)
    np.testing.assert_array_equal(got._codes[0], j._codes[0])
    opq = os.path.join(s["root"], "opq_index.npz")
    run.run_target(_build(s, opq, pq={**pq_cfg, "opq_iters": 1}), "t", "s",
                   s["names"], device="cpu")
    rot = load_index(opq, devices=["cpu"]).rotation
    np.testing.assert_allclose(rot.T @ rot, np.eye(512), atol=1e-4)


def test_infer_incrementally_matches_jax(setup):
    """Only the new names are inferred; the existing values pass through,
    the rest match the JAX stage's within 1e-4."""
    s = setup
    params = {"network": _network(s), "data": _data(s),
              "output": {"type": "embedding"}}
    old = s["names"][:3]
    old_vals = np.arange(3 * 512, dtype=np.float32).reshape(3, 512)
    new = [s["names"][4], s["names"][1], s["names"][6]]
    tmeta, tids, tvals = infer_incrementally(params, (old, old_vals, new),
                                             device="cpu")
    jmeta, jids, jvals = j_incremental(params, (old, old_vals, new))
    assert tids == jids == new and tmeta["count"] == 2
    assert isinstance(tvals, np.ndarray) and tvals.shape == (3, 512)
    np.testing.assert_array_equal(tvals[1], old_vals[1])
    np.testing.assert_allclose(tvals, jvals, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="infer_incrementally needs"):
        run.run_target({"t": {"1_x": {
            "__function__": "gandtr_tpu.stages.infer_incrementally",
            **params}}}, "t", "s", s["names"], device="cpu")


def test_export_stage_matches_jax(setup):
    """The export stage of either package on the same checkpoint: the
    port's loaded artifact within 1e-4 of the JAX package's."""
    s = setup
    img = np.stack([np.asarray(Image.open(os.path.join(s["photos"], n))
                               .resize((64, 48))) for n in s["names"][:2]])

    def scen(directory):
        return {"t": {"1_export": {
            "__function__": "gandtr_tpu.stages.export",
            "network": _network(s),
            "export": {"directory": directory, "image_hw": [48, 64],
                       "batch_buckets": [2]}}}}
    tdir = os.path.join(s["root"], "art_port")
    jdir = os.path.join(s["root"], "art_jax")
    tout = run.run_target(scen(tdir), "t", "s", device="cpu")["1_export"]
    jout = jrun.run_target(scen(jdir), "t", "s")["1_export"]
    assert tout == {"directory": tdir, "kind": "embedding",
                    "batch_buckets": [2], "image_hw": [48, 64]}
    assert {k: v for k, v in jout.items() if k != "directory"} == \
        {k: v for k, v in tout.items() if k != "directory"}
    got = load_artifact(tdir, device="cpu")(img)
    want = j_load_artifact(jdir)(img)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    bad = scen(os.path.join(s["root"], "z"))
    bad["t"]["1_export"]["export"]["bogus"] = 1
    with pytest.raises(ValueError, match="Unused export"):
        run.run_target(bad, "t", "s", device="cpu")


def test_export_stage_serves_the_index_descriptors(setup, tmp_path):
    """eval.yml's network form (an Lw pickle, then 3 scales) in both
    stages: the exported artifact answers the descriptors build_index
    indexed (the multiscale power is GeM's p in both)."""
    s = setup
    rng = np.random.RandomState(4)
    lw = {"P": np.linalg.qr(rng.randn(512, 512))[0].astype(np.float32),
          "m": (rng.randn(512, 1) * 0.01).astype(np.float32)}
    with open(tmp_path / "lw.pkl", "wb") as f:
        pickle.dump(lw, f)
    # path only: the model and its data params (CLAHE) come from the
    # checkpoint, for both stages
    net = {"path": s["ckpt"], "runtime": {"wrappers": {"eval": {
        "0_cirwhiten": {"whitening": str(tmp_path / "lw.pkl"),
                        "dimensions": None},
        "1_cirmultiscale": {"scales": True}}}}}
    names = s["names"][:2]
    run.run_target({"t": {"1_index": {
        "__function__": "gandtr_tpu.stages.build_index", "network": net,
        "data": {"image_dir": s["photos"]},
        "index": {"path": str(tmp_path / "i.npz")}}}}, "t", "s", names,
        device="cpu")
    run.run_target({"t": {"1_export": {
        "__function__": "gandtr_tpu.stages.export", "network": net,
        "export": {"directory": str(tmp_path / "art"), "image_hw": [60, 80],
                   "batch_buckets": [2]}}}}, "t", "s", device="cpu")
    img = np.stack([np.asarray(Image.open(os.path.join(s["photos"], n)))
                    for n in names])
    got = load_artifact(str(tmp_path / "art"), device="cpu")(img)
    with np.load(tmp_path / "i.npz") as z:
        np.testing.assert_allclose(got, z["vecs"], atol=1e-5, rtol=0)


def test_lw_wrapper_follows_the_descriptors_device():
    """An Lw wrapper a net config builds (`cirwhiten` with P and m) holds
    its matrices on the host; its post moves them to the descriptors'
    device (here the meta device stands for the card)."""
    from gandtr_tpu_torch.learning.wrappers import initialize_wrappers
    rng = np.random.RandomState(6)
    (w,) = initialize_wrappers({"0_cirwhiten": {
        "P": rng.randn(8, 8).astype(np.float32),
        "m": rng.randn(8, 1).astype(np.float32), "dimensions": 4}})
    assert w.P.device.type == "cpu"
    y = w.post(torch.empty((3, 8), device="meta"), {}, None)
    assert y.shape == (3, 4) and y.device.type == "meta"
    assert w.P.device.type == w.m.device.type == "meta"


# ---- the file readers and configdataset_tsv

def _write_tables(root):
    rows = {"query": ["q0", "q1", "q2"],
            "bbx": ["[1, 2, 30, 40]", "", "[0, 0, 5, 5]"],
            "ok": ['["a", "b"]', '["c"]', "[]"],
            "junk": ["[]", '["a"]', '["b", "c"]']}
    header = list(rows)
    lines = ["\t".join(header)] + ["\t".join(rows[k][i] for k in header)
                                   for i in range(3)]
    (root / "queries.tsv").write_text("\n".join(lines) + "\n")
    with gzip.open(root / "queries.tsv.gz", "wt") as f:
        f.write("\n".join(lines) + "\n")
    (root / "db.csv").write_text("identifier,x\na,1\nb,2\nc,3\nd,4\n")
    (root / "db.tsv").write_text("identifier\na\nb\nc\nd\n")
    with open(root / "cols.pkl", "wb") as f:
        pickle.dump({"identifier": ["a", "b", "c", "d"],
                     "v": np.arange(4)}, f)
    (root / "items_day.lst").write_text("x1\ny1\n[1, 2]\n")
    (root / "items_night.lst").write_text("x2\ny2\nz2\n")
    (root / "cols.json").write_text(json.dumps({"identifier": ["a", "b"],
                                                "n": 7}))
    import h5py
    with h5py.File(root / "cols.h5", "w") as f:
        f["identifier"] = np.array([b"a", b"b", b"c"], dtype=object)
        f["v"] = np.arange(3) * 1.5
        f.attrs["header"] = ["identifier", "v"]


@pytest.mark.parametrize("name,kw", [
    ("queries.tsv", {}), ("queries.tsv.gz", {"keys": ["ok", "bbx"]}),
    ("db.csv", {"partitions": 2, "slice": 1}), ("db.tsv", {"limit": 3}),
    ("cols.pkl", {}), ("cols.pkl", {"partitions": 2}),
    ("items_[day|night].lst", {}), ("cols.json", {"keys": ["identifier"]}),
    ("cols.h5", {}), ("cols.h5", {"keys": ["v"], "limit": 2}),
    ("queries.tsv#1:3", {})])
def test_file_readers_match_jax(tmp_path, name, kw):
    _write_tables(tmp_path)
    path = str(tmp_path / name)
    with tfr.initialize_file_reader(path, **kw) as r:
        got = r.get()
    with jfr.initialize_file_reader(path, **kw) as r:
        want = r.get()
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k
    with pytest.raises(ValueError, match="not supported"):
        tfr.initialize_file_reader(str(tmp_path / "x.parquet"))


def test_configdataset_tsv_matches_jax(tmp_path):
    _write_tables(tmp_path)
    ds = {"name": "tiny", "queries": str(tmp_path / "queries.tsv"),
          "db": str(tmp_path / "db.tsv"), "imgdir": "/photos"}
    got = configdataset_tsv(dict(ds))
    assert got == j_tsv(dict(ds))
    assert got["gnd"][2] == {"ok": [], "junk": [1, 2]}
    assert got["bbxs"] == [(1, 2, 30, 40), None, (0, 0, 5, 5)]
    assert got["im_paths"][0] == "/photos/a.jpg"
    with pytest.raises(ValueError, match="exactly"):
        configdataset_tsv({**ds, "extra": 1})
