"""The port's retrieval eval (eval/retrieval.py, scenarios/validate_stage.py
and the modules under them) against the JAX package's, on the CPU.

The data is a seeded synthetic roxford5k-style set (as
tests/test_eval_retrieval.py makes one) with rectangles of several shapes,
some larger than `image_size` so that LANCZOS downsizes them, and queries
with bbx crops; with `shape_bucket: 64` every image pads into the bucket.
Both packages load one reference-format .pth made from the JAX net's
initial weights (utils/weights.py::from_jax_variables) and one seeded Lw
pickle. The JAX chain runs its CLAHE on the host (eagerly, so no XLA jit
contracts a multiply-add in it) and its net on one device, as its own
tests run it."""
import copy
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from PIL import Image

import chip_smoke

from gandtr_tpu.data.datasets import imread as j_imread
from gandtr_tpu.learning import wrappers as jw
from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.ops import maskprop as jmaskprop
from gandtr_tpu.ops import resize as jresize
from gandtr_tpu.scenarios import validate_stage as jvalidate
from gandtr_tpu.utils import io as jio
from gandtr_tpu_torch.data.datasets import imread
from gandtr_tpu_torch.eval import retrieval as R
from gandtr_tpu_torch.hub import _init_random
from gandtr_tpu_torch.learning.checkpoints import Checkpoints
from gandtr_tpu_torch.learning.training import Training
from gandtr_tpu_torch.learning import wrappers as tw
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.ops.maskprop import MaskState, mask_from_sizes
from gandtr_tpu_torch.ops.resize import masked_scale_resize, scale_resize
from gandtr_tpu_torch.scenarios import validate_stage as tvalidate
from gandtr_tpu_torch.scenarios.infer_stage import _load_network
from gandtr_tpu_torch.utils import io as tio
from gandtr_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"architecture": "cirnet", "cir_architecture": "vgg16",
         "pooling": "gem", "local_whitening": False, "whitening": False,
         "regional": False}
IMNET = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
# (h, w) of the database images: some above image_size 64 (downsized),
# some below it (kept), portrait and landscape
DB_SHAPES = [(48, 48), (45, 61), (96, 72), (61, 40), (80, 106), (52, 52),
             (33, 64), (64, 50), (70, 93), (58, 47)]
QUERY_SHAPES = [(56, 60), (90, 120)]
QUERY_BBX = [[2, 3, 50, 52], [10, 5, 110, 85]]


def _image(rng, h, w, group):
    """A group's base colour with a seeded smooth pattern and noise."""
    base = np.array([0.2, 0.45, 0.7])[group]
    yy, xx = np.mgrid[:h, :w]
    pattern = 0.15 * np.sin(yy / (3.0 + group) + xx / (5.0 - group))
    arr = base + pattern[..., None] + rng.rand(h, w, 3) * 0.2
    return Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """{dir_main, lw, ckpt, jpgs}: the set, a seeded Lw pickle and a .pth of
    the JAX net's initial weights."""
    root = tmp_path_factory.mktemp("eval_data")
    jpg = root / "roxford5k" / "jpg"
    jpg.mkdir(parents=True)
    rng = np.random.RandomState(0)
    groups = [i % 3 for i in range(len(DB_SHAPES))]
    imlist = []
    for i, (h, w) in enumerate(DB_SHAPES):
        _image(rng, h, w, groups[i]).save(jpg / f"db{i}.jpg")
        imlist.append(f"db{i}")
    qimlist, gnd = [], []
    for q, ((h, w), bbx) in enumerate(zip(QUERY_SHAPES, QUERY_BBX)):
        _image(rng, h, w, q).save(jpg / f"q{q}.jpg")
        qimlist.append(f"q{q}")
        same = [i for i, g in enumerate(groups) if g == q]
        other = [i for i, g in enumerate(groups) if g != q]
        gnd.append({"easy": np.asarray(same[:2]), "hard": np.asarray(same[2:]),
                    "junk": np.asarray(other[:1]), "bbx": bbx})
    with open(root / "roxford5k" / "gnd_roxford5k.pkl", "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd}, f)

    P = np.linalg.qr(rng.randn(512, 512))[0].astype(np.float32)
    m = (rng.randn(512, 1) * 0.01).astype(np.float32)
    with open(root / "lw.pkl", "wb") as f:
        pickle.dump({"P": P, "m": m}, f)

    jnet = j_initialize_model(MODEL)
    variables = jnet.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    torch.save({"model_state": state, "network_params": {
        "model": MODEL, "runtime": {"data": {
            "transforms": "pil2np | apply_clahe:1.0 | totensor | normalize",
            "mean_std": IMNET}}}}, root / "net.pth")
    return {"dir_main": str(root), "lw": str(root / "lw.pkl"),
            "ckpt": str(root / "net.pth"),
            "jpgs": sorted(str(p) for p in jpg.iterdir())}


def _params(data, bucket=64, path=None):
    """eval.yml's sections at a test size: image_size 64, the set's Lw."""
    return {
        "network": {"type": "SingleNetwork", "path": path or data["ckpt"],
                    "model": dict(MODEL),
                    "runtime": {"wrappers": {"eval": {
                        "0_cirwhiten": {"whitening": data["lw"],
                                        "dimensions": None},
                        "1_cirmultiscale": {"scales": True}}}}},
        "data": {"image_size": 64, "shape_bucket": bucket,
                 "transforms": "pil2np | apply_clahe:1.0 | totensor | "
                               "normalize",
                 "mean_std": IMNET},
        "validation": {"dir_main": data["dir_main"],
                       "datasets": ["roxford5k"]},
    }


@pytest.fixture(scope="module")
def jax_run(dataset):
    params = _params(dataset)
    # host CLAHE (eager) and one device: see the module docstring
    params["data"].update(device_preprocess=False, parallel_extract=False)
    (out,), rec = chip_smoke._recorded(
        jvalidate, lambda: jvalidate.validate(params, ()))
    return out["metadata"]["validation"], rec[0]


@pytest.fixture(scope="module")
def port_runs(dataset):
    runs = {}
    for bucket in (64, None):
        (out,), rec = chip_smoke._recorded(
            tvalidate, lambda: tvalidate.validate(
                _params(dataset, bucket), None, device="cpu"))
        runs[bucket] = (out["metadata"]["validation"], rec[0])
    return runs


# ---- modules 1 and 2: paths and the decoder

@pytest.mark.parametrize("rules", [None, [("^", "/data/root")],
                                   [("^test/", "/mnt/"), ("^", "/x")]])
@pytest.mark.parametrize("path", ["data/test", "test/a.pkl", "/abs/lw.pkl",
                                  "http://host/lw.pkl", "$HOME/lw.pkl"])
def test_resolve_path_equals_jax(monkeypatch, path, rules):
    monkeypatch.setenv("GANDTR_ROOT", "/srv/gandtr")
    assert tio.resolve_path(path, rules) == jio.resolve_path(path, rules)


def test_load_pickle_is_local_only(tmp_path):
    with open(tmp_path / "a.pkl", "wb") as f:
        pickle.dump({"P": 1}, f)
    assert tio.load_pickle(str(tmp_path / "a.pkl")) == {"P": 1}
    with pytest.raises(ValueError, match="local"):
        tio.load_pickle("http://host/a.pkl")


def test_decoders_agree(dataset):
    """The JAX imread (its native libjpeg decoder where it loads) and the
    port's PIL imread give equal arrays on every JPEG of the set."""
    for path in dataset["jpgs"]:
        np.testing.assert_array_equal(np.asarray(imread(path)),
                                      np.asarray(j_imread(path)))


# ---- module 4: masked_scale_resize

@pytest.mark.parametrize("scale", [0.5, 1 / np.sqrt(2), np.sqrt(2)])
@pytest.mark.parametrize("hw", [(100, 73), (64, 64), (47, 101)])
def test_masked_scale_resize_exact(hw, scale):
    """Bit-equal to F.interpolate on the exact crop, sizes floor(h*s) on the
    device and the host, zero band; within 1e-5 of the JAX resize (which
    combines the taps in another order)."""
    h, w = hw
    rng = np.random.RandomState(0)
    im = rng.rand(h, w, 3).astype(np.float32)
    buf = np.zeros((1, 128, 128, 3), np.float32)
    buf[0, :h, :w] = im
    st = MaskState((torch.tensor([h]), torch.tensor([w])), [(h, w)])
    out, st2 = masked_scale_resize(torch.from_numpy(buf), st, scale)
    exact = F.interpolate(torch.from_numpy(im).permute(2, 0, 1)[None],
                          scale_factor=scale, mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0)
    eh, ew = exact.shape[:2]
    assert out.shape == (1, int(128 * scale), int(128 * scale), 3)
    assert st2.host_hw() == [(eh, ew)]
    assert (int(st2.hw[0][0]), int(st2.hw[1][0])) == (eh, ew)
    assert torch.equal(out[0, :eh, :ew], exact)
    assert not out[0, eh:].any() and not out[0, :, ew:].any()

    jst = jmaskprop.MaskState((jnp.asarray([h], jnp.int32),
                               jnp.asarray([w], jnp.int32)))
    jout, jst2 = jresize.masked_scale_resize(jnp.asarray(buf), jst, scale)
    assert (int(jst2.hw[0][0]), int(jst2.hw[1][0])) == (eh, ew)
    np.testing.assert_allclose(out[0, :eh, :ew].numpy(),
                               np.asarray(jout[0, :eh, :ew]), atol=1e-5,
                               rtol=0)


def test_masked_scale_resize_batch_reads_no_device_size():
    """A batch of rectangles: each row equals its own exact resize, and the
    host sizes given are the ones used (the device sizes disagree here on
    purpose, and are not read)."""
    rng = np.random.RandomState(1)
    rects = [(40, 30), (17, 64), (64, 64)]
    x = torch.from_numpy(rng.rand(3, 64, 64, 3).astype(np.float32))
    st = MaskState((torch.zeros(3, dtype=torch.int64),) * 2, rects)
    out, st2 = masked_scale_resize(x, st, 1 / np.sqrt(2))
    for i, (h, w) in enumerate(rects):
        want = scale_resize(x[i:i + 1, :h, :w].contiguous(), 1 / np.sqrt(2))
        assert st2.host_hw()[i] == tuple(want.shape[1:3])
        assert torch.equal(out[i:i + 1, :want.shape[1], :want.shape[2]],
                           want)


# ---- module 6: wrappers

@pytest.mark.parametrize("scales", list(jw.CirMultiscaleAggregation
                                        .SCALE_SETS) + [True, False,
                                                        [1, 0.5]])
def test_scale_sets_equal_jax(scales):
    assert tw.CirMultiscaleAggregation(scales).scales == \
        jw.CirMultiscaleAggregation(scales).scales


@pytest.mark.parametrize("cfg", [
    MODEL, dict(MODEL, whitening=True), dict(MODEL, regional=True),
    dict(MODEL, pooling="mac"), {}, None])
def test_multiscale_msp_equals_jax(cfg):
    module = build_single_net({"model": MODEL}).module
    with torch.no_grad():
        module.pool.p.fill_(2.75)
    params = {"gem_p": np.full((1,), 2.75, np.float32)}
    assert tw.multiscale_msp(cfg, module) == \
        jw.multiscale_msp(cfg, {"params": params})


@pytest.mark.parametrize("spec", [
    "cirmultiscale:ms", "cirmultiscale:sms5", "cirmultiscale:True",
    {"1_cirmultiscale": {"scales": "sms"}},
    {"1_cirmultiscale": {"scales": True}, "0_cirmultiscale": None}])
def test_wrapper_forms_equal_jax(spec):
    """The string DSL and the sorted dict give the same wrappers and
    scales as the JAX package."""
    got = tw.initialize_wrappers(copy.deepcopy(spec))
    want = jw.initialize_wrappers(copy.deepcopy(spec)
                                  if not isinstance(spec, dict) else
                                  {k: v or {} for k, v in spec.items()})
    assert [type(w).__name__ for w in got] == \
        [type(w).__name__ for w in want]
    assert [np.asarray(w.scales).tolist() for w in got] == \
        [np.asarray(w.scales).tolist() for w in want]


def test_eval_wrappers_from_a_train_eval_dict():
    net = build_single_net({"model": MODEL, "runtime": {"wrappers": {
        "eval": {"1_cirmultiscale": {"scales": "ss"}}}}})
    assert net.wrappers_train == []
    assert [w.scales for w in net.wrappers_eval] == [[1]]


# ---- modules 4, 6, 7: bucketed against exact in the port

@pytest.mark.parametrize("hw", [(96, 67), (53, 96)])
def test_bucketed_multiscale_equals_exact(hw):
    """The masked multiscale forward of a padded image equals the exact
    one (tests/test_exact_bucketing.py holds the JAX package to the
    same)."""
    net = build_single_net({"model": MODEL})
    net.wrappers_eval = [tw.CirMultiscaleAggregation(scales=True)]
    msp = tw.multiscale_msp(MODEL, net.module)
    h, w = hw
    im = torch.from_numpy(np.random.RandomState(2).rand(1, h, w, 3)
                          .astype(np.float32))
    buf = torch.zeros((1, 96, 96, 3))
    buf[:, :h, :w] = im
    mask = mask_from_sizes((torch.tensor([h]), torch.tensor([w])), 96, 96)
    with torch.inference_mode():
        exact = net.apply(im, ctx={"msp": msp})
        got = net.apply(buf, ctx={"msp": msp}, mask=mask, host_hw=[hw])
    assert float((got - exact).abs().max()) < 1e-5


def test_extractor_batch_equals_single(dataset):
    """Two images of one bucket through `batch` and one by one."""
    net = _load_network({"model": MODEL}, torch.device("cpu"))
    net.wrappers_eval = [tw.CirMultiscaleAggregation(scales=True)]
    ex = R.ShapeCachedExtractor(
        lambda x, m, hw: net.apply(x.float() / 255, mask=m, host_hw=hw),
        shape_bucket=64)
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, s + (3,), dtype=np.uint8)
            for s in ((64, 49), (50, 61))]
    assert ex.group_key(imgs[0]) == ex.group_key(imgs[1]) == (64, 64, 3)
    together = torch.stack(ex.batch(imgs))
    alone = torch.stack([ex(im) for im in imgs])
    assert float((together - alone).abs().max()) < 1e-5


def test_port_bucketed_equals_exact(port_runs):
    """validate with shape_bucket 64 and with null: descriptors within 1e-5
    (multiscale, CLAHE and Lw on), and equal mAPs."""
    (mb, (metrics_b, _, vb, qb)), (me, (metrics_e, _, ve, qe)) = \
        port_runs[64], port_runs[None]
    assert vb.shape == (512, len(DB_SHAPES)) and qb.shape == (512, 2)
    np.testing.assert_allclose(vb, ve, atol=1e-5, rtol=0)
    np.testing.assert_allclose(qb, qe, atol=1e-5, rtol=0)
    assert metrics_b == metrics_e
    assert mb["config:data.shape_bucket"] == 64
    assert me["config:data.shape_bucket"] is None


@pytest.mark.parametrize("bucket", [64, None])
def test_loader_batches_equal_single_images(dataset, port_runs, bucket):
    """`loader.batch_size: 3` groups images of one bucket (or one exact
    shape) into batches: the descriptors of batch 1."""
    params = _params(dataset, bucket)
    params["data"]["loader"] = {"batch_size": 3}
    _, rec = chip_smoke._recorded(tvalidate, lambda: tvalidate.validate(
        params, None, device="cpu"))
    _, (_, _, v1, q1) = port_runs[bucket]
    np.testing.assert_allclose(rec[0][2], v1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(rec[0][3], q1, atol=1e-5, rtol=0)


# ---- the slice: the port's validate against the JAX package's

def test_validate_descriptors_match_jax(jax_run, port_runs):
    _, (_, _, jv, jq) = jax_run
    _, (_, _, tv, tq) = port_runs[64]
    np.testing.assert_allclose(np.linalg.norm(tv, axis=0), 1.0, atol=1e-5)
    np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tq, jq, atol=1e-4, rtol=0)


def test_validate_metadata_keys_match_jax(jax_run, port_runs):
    jmeta, _ = jax_run
    tmeta, _ = port_runs[64]
    assert sorted(tmeta) == sorted(jmeta)
    assert tmeta["config:data.shape_bucket"] == 64


def test_validate_maps_equal_jax(jax_run, port_runs):
    """Equal mAPs, once the JAX scores are shown to order each query's
    database by gaps wider than the descriptors' tolerance can close."""
    jmeta, (_, _, jv, jq) = jax_run
    tmeta, _ = port_runs[64]
    scores = np.sort(jv.T.astype(np.float64) @ jq.astype(np.float64),
                     axis=0)
    assert np.diff(scores, axis=0).min() > 4e-4
    assert tmeta == jmeta


# ---- the stage's set-up

def test_null_whitening_raises(dataset):
    params = _params(dataset)
    params["network"]["runtime"]["wrappers"]["eval"]["0_cirwhiten"][
        "whitening"] = None
    with pytest.raises(ValueError, match="whitening"):
        tvalidate.validate(params, None, device="cpu")


def test_path_only_network_adopts_the_checkpoint(dataset):
    """A path-only section takes the checkpoint's model and data params."""
    net = _load_network({"type": "SingleNetwork", "path": dataset["ckpt"]},
                        torch.device("cpu"))
    assert net.loaded_model_cfg == MODEL
    assert net.data_params["mean_std"] == IMNET
    want = torch.load(dataset["ckpt"], weights_only=False)["model_state"]
    for k, v in net.module.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_port_network_file_loads(dataset, tmp_path):
    """`epochs/embed_best.ckpt` as the port's Checkpoints writes it (the
    fine-tune's network file, which steps 2 and 4 of the finetune targets
    load): a path-only section takes its model, every key of its state
    loads, none is left over, and the descriptors equal the saved net's."""
    saved = build_single_net({"model": MODEL})
    _init_random(saved.module, 5)
    training = Training(step_fn=None, loader=None, epochs=1,
                        net_params={"embed": {"model": MODEL, "runtime": {
                            "wrappers": "cirfaketuplebatch"}}})
    ckpts = Checkpoints(str(tmp_path))
    ckpts.save_epoch(1, {"embed": training._net_file(
        SimpleNamespace(models={"embed": saved}), "embed")},
        is_best=True, is_last=True)
    path = tmp_path / "epochs" / "embed_best.ckpt"
    assert path.is_symlink()
    net = _load_network({"type": "SingleNetwork", "path": str(path)},
                        torch.device("cpu"))
    assert net.loaded_model_cfg == MODEL
    got, want = net.module.state_dict(), saved.module.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 40, 56, 3)
                         .astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(net.apply(x), saved.module.eval()(x))


@pytest.mark.parametrize("url", ["http://host/embed_best.ckpt",
                                 "https://host/net.pth"])
def test_url_network_path_is_refused(url):
    with pytest.raises(NotImplementedError, match="downloads nothing"):
        _load_network({"path": url}, torch.device("cpu"))


def test_validation_forms():
    """`{dir_main, datasets}` and the MultiCriterialValidation tree with a
    per-criterion image_size."""
    assert tvalidate._plan({"datasets": ["roxford5k", "rparis6k"]}, 1024) \
        == [("roxford5k", "roxford5k", 1024), ("rparis6k", "rparis6k", 1024)]
    tree = {"type": "MultiCriterialValidation", "decisive_criterion": "rox",
            "rox": {"criterion": {"type": "cirdatasetap",
                                  "dataset": "roxford5k",
                                  "image_size": 512}},
            "tokyo": {"criterion": {"dataset": "247tokyo1k"}}}
    assert tvalidate._plan(tree, 1024) == [("rox", "roxford5k", 512),
                                           ("tokyo", "247tokyo1k", 1024)]
    with pytest.raises(NotImplementedError):
        tvalidate._plan({"x": {"criterion": {"type": "loss"}}}, 1024)


def test_chip_smoke_eval_config_is_eval_yml():
    """The chip smoke's eval phase runs eval.yml's sections as shipped."""
    with open(os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs",
                           "iccv23", "parameters", "eval.yml")) as f:
        shipped = yaml.safe_load(f)
    assert chip_smoke.EVAL == shipped
