"""The fine-tune's validations and the training options around them in the
port against the JAX package's, on the CPU:

- the build's validation section (`learning.validation` + `data.val`,
  LossValidation over val tuples mined with the current weights) on
  tests/test_torch_finetune_loop.py's micro chain without `clahepost`
  (the JAX mining chain runs jitted, whose CLAHE may move a level), on a
  tuple pickle with a `val` split: the val tuples and losses of each epoch
  against the JAX validation's on the same weights, `_best` following the
  lowest loss, the TensorBoard file and the profile trace of that run;
- ScoreValidation against the JAX class on a micro roxford5k-style set;
- the triplet, multi-descriptor and base criteria against the JAX ones,
  and one triplet fine-tune step;
- the TensorBoard records against the JAX writer's;
- the refusals of the GAN build's device scalecrop."""
import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu.data.transforms import initialize_transforms as j_transforms
from gandtr_tpu.learning import criteria as JC
from gandtr_tpu.learning import network as jnetwork
from gandtr_tpu.learning import tensorboard as JTB
from gandtr_tpu.learning.training import ScoreValidation as JScore
from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.scenarios import finetune_build as jfb
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.data import transforms as T
from gandtr_tpu_torch.data.mining import cid2filename
from gandtr_tpu_torch.learning import criteria as PC
from gandtr_tpu_torch.learning import tensorboard as TB
from gandtr_tpu_torch.learning.events import EventBroker, MetadataKeeper
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.learning.training import ScoreValidation
from gandtr_tpu_torch.scenarios import finetune_build
from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_finetune_loop import (WRAPPERS_NO_CLAHE, _same_weights,
                                      _shape_init, micro_params)
from torch_gan_common import micro_config, seeded_variables

torch.set_num_threads(1)

IMNET = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
SCORE_TF = "pil2np | apply_clahe:1.0 | totensor | normalize"
EPOCHS = 2
VAL_KEY = "val/learning/loss:total"


def _tuple_set(root):
    """24 seeded 48x40 JPEGs in the SfM-120k cid tree: 16 in a train split
    of 8 clusters, 8 in a val split of 4; one pickle with both splits."""
    imgdir = root / "ims"
    rng = np.random.RandomState(0)
    cids = []
    for i in range(24):
        cid = "cid%06d" % (37 * i + 5)
        path = cid2filename(cid, str(imgdir))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray((rng.rand(48, 40, 3) * 255).astype(np.uint8)).save(
            path, format="JPEG")
        cids.append(cid)
    db = {"train": {"cids": cids[:16], "cluster": [i // 2 for i in range(16)],
                    "qidxs": [0, 2, 4, 6], "pidxs": [1, 3, 5, 7]},
          "val": {"cids": cids[16:], "cluster": [i // 2 for i in range(8)],
                  "qidxs": [0, 2, 4], "pidxs": [1, 3, 5]}}
    with open(root / "db.pkl", "wb") as f:
        pickle.dump(db, f)
    return str(root / "db.pkl"), str(imgdir)


def _val_params(pkl, imgdir, profile=None):
    params = micro_params(WRAPPERS_NO_CLAHE)
    params["data"]["train"]["dataset"].update(dataset_pkl=pkl,
                                              image_dir=imgdir)
    params["data"]["val"] = {"dataset": {
        "name": "CirTuples", "split": "val", "neg_num": 2, "query_size": 3,
        "pool_size": 8}}
    params["learning"]["validation"] = {"type": "SingleValidation",
                                        "frequency": 1}
    params["output"]["learning"]["tensorboard"] = {}
    if profile:
        params["output"]["learning"]["profile"] = profile
    return params


class _Recorder:
    """A stand-in event broker: the values each validation logs."""

    def __init__(self):
        self.values = []

    def logger(self, prefix, epoch, epoch_size=None):
        def register(key, value, dtype="scalar/loss", iteration=None):
            self.values.append((epoch, key, float(value)))
        return register


@pytest.fixture(scope="module")
def val_run(tmp_path_factory):
    """The port's 2-epoch loop with the validation section, its val
    tuples and its embed weights at each validation; then the JAX build's
    validation on those weights."""
    root = tmp_path_factory.mktemp("ftval")
    pkl, imgdir = _tuple_set(root)
    params = _val_params(pkl, imgdir, profile=str(root / "profile"))
    pexp = finetune_build.build_finetune_experiment(
        copy.deepcopy(params), directory=str(root / "port"), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnetwork.WrappedNet, "init", _shape_init)
        jexp = jfb.build_finetune_experiment(copy.deepcopy(params))
    variables = _same_weights(pexp, jexp)     # the port's augment re-set
    (pval,) = pexp["training"].validations
    rec = {"tuples": [], "embed": [], "holder_is_state": []}
    prepare, on_validate = pval.loader.dataset.prepare_epoch, pval.on_validate

    def recording_on_validate(state):
        on_validate(state)
        rec["holder_is_state"].append(
            pval.loader.dataset.extract_fn.holder["state"] is state)
        rec["embed"].append({k: v.detach().clone() for k, v in
                             state.models["embed"].module.state_dict()
                             .items()})

    def recording_prepare():
        out = prepare()
        rec["tuples"].append(copy.deepcopy(pval.loader.dataset.tuples))
        return out
    pval.on_validate = recording_on_validate
    pval.loader.dataset.prepare_epoch = recording_prepare
    pexp["training"].run(pexp["state"])

    (jval,) = jexp["training"].validations
    # one compile of the JAX validation's loss, not an op-by-op run
    jval.loss_fn = jax.jit(jval.loss_fn)
    jrec, jtuples = _Recorder(), []
    jprepare = jval.loader.dataset.prepare_epoch

    def jrecording_prepare():
        out = jprepare()
        jtuples.append(copy.deepcopy(jval.loader.dataset.tuples))
        return out
    jval.loader.dataset.prepare_epoch = jrecording_prepare
    for epoch, embed in enumerate(rec["embed"], 1):
        jvar = dict(variables)
        jvar["embed"] = jax.tree_util.tree_map(
            jnp.asarray, ti.convert_torch_state(
                jexp["variables"]["embed"],
                {k: v.numpy() for k, v in embed.items()},
                key_map=ti.key_map_for_architecture("cirnet"),
                min_coverage=1.0))
        jval(jexp["state"].replace(variables=jvar), epoch, jrec)
    return {"root": root, "pexp": pexp, "rec": rec, "jrec": jrec,
            "jtuples": jtuples}


def test_val_tuples_and_losses_against_jax(val_run):
    """Each epoch's val tuples, mined by the port with that epoch's
    weights, equal the JAX validation's on the same weights, and the val
    loss is within 1e-5 of its."""
    rec, pexp = val_run["rec"], val_run["pexp"]
    assert rec["holder_is_state"] == [True] * EPOCHS
    assert len(rec["tuples"]) == len(val_run["jtuples"]) == EPOCHS
    for pt, jt in zip(rec["tuples"], val_run["jtuples"]):
        assert [(int(q), int(p), [int(n) for n in ns]) for q, p, ns in pt] \
            == [(int(q), int(p), [int(n) for n in ns]) for q, p, ns in jt]
    ploss = [h["metrics"][VAL_KEY] for h in pexp["events"].history]
    jloss = [v for _, k, v in val_run["jrec"].values if k == VAL_KEY]
    assert len(ploss) == len(jloss) == EPOCHS
    assert all(np.isfinite(ploss))
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5, atol=1e-7)


def test_best_follows_the_lowest_val_loss(val_run):
    """`val/learning/loss:total` is the decisive criterion: `_best` is
    the epoch of the lowest validation loss (the JAX losses pick the same
    epoch) and its files are the best checkpoint's."""
    pexp = val_run["pexp"]
    jloss = [v for _, k, v in val_run["jrec"].values if k == VAL_KEY]
    best = int(np.argmin(jloss)) + 1
    assert pexp["events"].metadata.best_epoch() == best
    link = os.path.join(str(val_run["root"]), "port", "epochs",
                        "embed_best.ckpt")
    assert os.path.realpath(link).endswith("embed_epoch_%02d.ckpt" % best)


def test_tensorboard_file_of_the_run(val_run):
    """The run's event file parses back with valid CRCs, and its
    epoch-level scalars equal the events' history."""
    logdir = os.path.join(str(val_run["root"]), "port", "epochs",
                          "tensorboard")
    (name,) = os.listdir(logdir)
    events = TB.read_scalar_events(os.path.join(logdir, name))
    vals = [(step, v) for tag, v, step in events if tag == VAL_KEY]
    hist = val_run["pexp"]["events"].history
    # an epoch-level event sits at the epoch's end: epoch x epoch_size
    assert [v for _, v in vals] == pytest.approx(
        [h["metrics"][VAL_KEY] for h in hist], rel=1e-6)
    assert [s for s, _ in vals] == [1, 2]
    train = [v for tag, v, _ in events if tag == "train/learning/total"]
    assert len(train) == EPOCHS * len(val_run["pexp"]["loader"])


def test_profile_trace_is_written(val_run):
    path = os.path.join(str(val_run["root"]), "profile",
                        "epoch_%02d.trace.json" % EPOCHS)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert '"traceEvents"' in f.read(4096)


def test_tensorboard_records_against_jax(tmp_path):
    """For the same events at the same wall times the port's records are
    the JAX writer's byte for byte (framing and CRCs included); both
    files parse to the same (tag, value, step)s."""
    rows = [(1, 0, 3, "train/learning/total", 0.5, "scalar/loss"),
            (1, 2, 3, "train/learning/total", 0.25, "scalar/loss"),
            (1, None, None, "val/learning/loss:total", 1.5, "scalar/loss"),
            (2, 1, 3, "train/learning/total", 0.125, "scalar/loss"),
            (2, None, None, "blob", 0.0, "blob")]
    for tag, value, step in (("a/b", 0.1, 0), ("long/" * 40, -3.5, 2 ** 40)):
        assert TB.encode_scalar_event(tag, value, step, 12.5) == \
            JTB.encode_scalar_event(tag, value, step, 12.5)
    assert TB.encode_file_version(7.0) == JTB.encode_file_version(7.0)
    for data in (b"", b"abc", bytes(range(256))):
        assert TB.masked_crc(data) == JTB._masked_crc(data)
    files = []
    for mod, sub in ((TB, "port"), (JTB, "jax")):
        w = mod.TensorboardWriter(str(tmp_path / sub))
        for epoch, it, size, key, value, dtype in rows:
            w.register(epoch, it, size, key, value, dtype)
            w.close_epoch(epoch)
        w.close()
        logdir = tmp_path / sub / "epochs" / "tensorboard"
        (name,) = os.listdir(logdir)
        files.append(str(logdir / name))
    assert TB.read_scalar_events(files[0]) == \
        JTB.read_scalar_events(files[1]) == TB.read_scalar_events(files[1])
    assert len(TB.read_records(files[0])) == 5
    with open(files[0], "rb") as f:
        data = bytearray(f.read())
    data[-3] ^= 1
    bad = tmp_path / "bad.tfevents"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad record"):
        TB.read_records(str(bad))


# ---- ScoreValidation

MODEL = {"architecture": "cirnet", "cir_architecture": "vgg16",
         "pooling": "gem", "local_whitening": False, "whitening": False}
SCORE_SHAPE = (48, 64)      # every image: one JAX compile


@pytest.fixture(scope="module")
def score_set(tmp_path_factory):
    """A roxford5k-style set of 8 database and 2 query images of one
    shape in two groups, and the seeded VGG16 GeM net both packages
    take."""
    root = tmp_path_factory.mktemp("score")
    jpg = root / "roxford5k" / "jpg"
    jpg.mkdir(parents=True)
    rng = np.random.RandomState(1)
    h, w = SCORE_SHAPE

    def image(group):
        yy, xx = np.mgrid[:h, :w]
        arr = np.array([0.25, 0.7])[group] + 0.2 * np.sin(
            yy / (3.0 + 2 * group) + xx / 5.0)[..., None] \
            + rng.rand(h, w, 3) * 0.2
        return Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
    imlist = []
    for i in range(8):
        image(i % 2).save(jpg / ("db%d.jpg" % i))
        imlist.append("db%d" % i)
    gnd = []
    for q in range(2):
        image(q).save(jpg / ("q%d.jpg" % q))
        same = [i for i in range(8) if i % 2 == q]
        gnd.append({"easy": np.asarray(same[:2]),
                    "hard": np.asarray(same[2:]),
                    "junk": np.asarray([1 - q])})
    with open(root / "roxford5k" / "gnd_roxford5k.pkl", "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": ["q0", "q1"], "gnd": gnd},
                    f)
    jnet = j_initialize_model(dict(MODEL))
    shapes = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, h, w, 3)))
    variables = seeded_variables(dict(shapes), 4)
    variables["params"]["gem_p"] = np.full((1,), 3.0, np.float32)
    return {"dir_main": str(root), "jnet": jnet, "variables": variables}


def _keys_and_values(pairs):
    out = {}
    for _, key, value in pairs:
        out.setdefault(key, []).append(value)
    return out


@pytest.fixture(scope="module")
def jax_scores(score_set):
    class _State:
        variables = {"embed": jax.tree_util.tree_map(
            jnp.asarray, score_set["variables"])}
    tf = j_transforms(SCORE_TF, IMNET)
    rec = _Recorder()
    with jax.disable_jit(False):
        JScore(score_set["jnet"], "roxford5k", score_set["dir_main"],
               image_size=64, transform=tf)(_State(), 1, rec)
    return _keys_and_values(rec.values)


@pytest.mark.parametrize("transform", ["net", "host"])
def test_score_validation_against_jax(score_set, jax_scores, transform):
    """The same keys as the JAX ScoreValidation, and the same scores
    within 1e-6, with the net's own transform (its CLAHE and normalization
    on the net's device) or a host transform passed in, as the JAX test
    passes one; `_best` can follow a score."""
    net = build_single_net({"model": dict(MODEL), "runtime": {
        "wrappers": "", "data": {"transforms": SCORE_TF,
                                 "mean_std": IMNET}}})
    net.module.load_state_dict(
        from_jax_variables(score_set["variables"]), strict=True)

    class _State:
        models = {"embed": net}
    rec = _Recorder()
    tf = None if transform == "net" else T.initialize_transforms(SCORE_TF,
                                                                 IMNET)
    val = ScoreValidation(net, "roxford5k", score_set["dir_main"],
                          image_size=64, transform=tf)
    val(_State(), 1, rec)
    got = _keys_and_values(rec.values)
    assert sorted(got) == sorted(jax_scores)
    for key, values in jax_scores.items():
        if key.endswith("dataset:eval"):
            assert len(got[key]) == 1 and got[key][0] > 0
            continue
        np.testing.assert_allclose(got[key], values, rtol=0, atol=1e-6,
                                   err_msg=key)
    assert val.last_seconds > 0
    events = EventBroker(metadata=MetadataKeeper(
        "val/validation/roxford5k/score_avg:map_medium"))
    val(_State(), 1, events)
    agg = events.close_epoch(1)
    assert "val/validation/roxford5k/score:ap_medium" in agg
    assert events.metadata.best_epoch() == 1


# ---- criteria

def _tuple_descs(seed, d=16, s=7):
    rs = np.random.RandomState(seed)
    x = rs.randn(d, s).astype(np.float32)
    x /= np.linalg.norm(x, axis=0, keepdims=True)
    return x, np.asarray([-1, 1] + [0] * (s - 2), np.float32)


@pytest.mark.parametrize("margin", [0.1, 0.5, 2.0])
def test_triplet_against_jax(margin):
    for seed in range(4):
        x, lbl = _tuple_descs(seed)
        x2 = np.concatenate([x, _tuple_descs(seed + 10)[0]], axis=1)
        l2 = np.concatenate([lbl, lbl])
        for xx, ll, nt in ((x, lbl, 1), (x2, l2, 2)):
            got = PC.initialize_criterion({"loss": "triplet",
                                           "margin": margin})(
                torch.from_numpy(xx), torch.from_numpy(ll), num_tuples=nt)
            want = JC.initialize_criterion({"loss": "triplet",
                                            "margin": margin})(
                jnp.asarray(xx), jnp.asarray(ll), num_tuples=nt)
            np.testing.assert_allclose(float(got), float(want), rtol=2e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("weights", [None, "0.25,0.75", [2.0, 1.0, 0.5]])
def test_contrastive_multidesc_against_jax(weights):
    """The weighted sum over descriptor matrices and each matrix's part;
    a single matrix is the contrastive loss."""
    n = 3 if isinstance(weights, list) else 2
    xs = [_tuple_descs(s)[0] for s in range(n)]
    lbl = _tuple_descs(0)[1]
    cfg = {"loss": "contrastive_multidesc", "margin": 0.7,
           "weights": weights}
    got = PC.initialize_criterion(dict(cfg))(
        [torch.from_numpy(x) for x in xs], [torch.from_numpy(lbl)])
    want = JC.initialize_criterion(dict(cfg))(
        [jnp.asarray(x) for x in xs], [jnp.asarray(lbl)])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert sorted(got.partial) == sorted(want.partial)
    for k in want.partial:
        np.testing.assert_allclose(float(got.partial[k]),
                                   float(want.partial[k]), rtol=1e-6)
    single = PC.initialize_criterion(dict(cfg))(torch.from_numpy(xs[0]),
                                                torch.from_numpy(lbl))
    np.testing.assert_allclose(float(single), float(want.partial["0"]),
                               rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("l1", {}), ("l1", {"reduction": "sum"}), ("mse", {}),
    ("mse", {"reduction": "none"}), ("bce", {}),
    ("bce_with_logits", {}), ("bce_with_logits", {"pos_weight": 2.5})])
def test_base_criteria_against_jax(name, kwargs):
    rs = np.random.RandomState(2)
    x = rs.randn(3, 5).astype(np.float32)
    t = rs.rand(3, 5).astype(np.float32)
    if name == "bce":
        x = 1 / (1 + np.exp(-x))
    cfg = dict(kwargs, loss=name)
    got = PC.initialize_criterion(dict(cfg))(torch.from_numpy(x),
                                             torch.from_numpy(t))
    want = JC.initialize_criterion(dict(cfg))(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_loss_value_arithmetic_against_jax():
    """TotalWithIntermediate's flattening and arithmetic, and ZERO."""
    def build(mod, cast):
        inner = mod.TotalWithIntermediate(cast(3.0), a=cast(1.0),
                                          b=cast(2.0))
        v = mod.TotalWithIntermediate.from_partial(x=inner, y=cast(4.0))
        w = (v + v) * 0.5 - v / 2.0
        return v, w, mod.ZERO + v, v + cast(1.0)
    p = build(PC, lambda f: torch.tensor(f))
    j = build(JC, lambda f: jnp.asarray(f))
    for a, b in zip(p[:3], j[:3]):
        assert float(a) == float(b)
        assert sorted(a.partial) == sorted(b.partial)
        for k in a.partial:
            assert float(a.partial[k]) == float(b.partial[k])
    assert float(p[3]) == float(j[3])


@pytest.mark.parametrize("name", ["multihead_loss", "cycle_loss",
                                  "multilayer_patchnce_loss"])
def test_step_computed_criteria_raise_by_name(name):
    with pytest.raises(NotImplementedError, match=name):
        PC.initialize_criterion({"loss": name})


def test_triplet_finetune_step(val_run):
    """A fine-tune step with `criterion: {loss: triplet, margin: 0.1}`:
    finite, and its loss the JAX TripletLoss of the embed's descriptors
    of the same staged tuple."""
    params = copy.deepcopy(micro_params(WRAPPERS_NO_CLAHE))
    params["learning"]["training"]["criterion"] = {"loss": "triplet",
                                                   "margin": 0.1}
    exp = finetune_build.build_finetune_experiment(params, device="cpu")
    batch = next(iter(val_run["pexp"]["loader"]))
    args = [torch.from_numpy(np.asarray(a)) for a in batch]
    x, masks = exp["stage"](args[0], args[1])
    with torch.no_grad():
        aug = exp["models"]["augment"].apply(
            x[0], ctx={"pass_mask": args[3][0]}, train=True,
            mask=masks[0])
        xa, ma = aug if isinstance(aug, tuple) else (aug, masks[0])
        descs = exp["models"]["embed"].apply(xa, train=True, mask=ma)
    want = JC.TripletLoss(margin=0.1)(jnp.asarray(descs.T.numpy()),
                                      jnp.asarray(args[2][0].numpy()))
    one = [a[:1] for a in args]
    _, m = exp["step"](exp["state"], *one)
    assert np.isfinite(float(m["total"]))
    np.testing.assert_allclose(float(m["total"]), float(want), rtol=1e-5,
                               atol=1e-7)


# ---- refusals

def test_device_scalecrop_refusals(tmp_path):
    """A device scalecrop on a chain other than `pil2np | scalecrop |
    totensor | normalize` raises (the JAX package warns and trains
    without it); with the teacher cache it raises, as in the JAX
    package."""
    cfg = micro_config(str(tmp_path))
    cfg["data"]["train"]["device_scalecrop"] = True
    bad = copy.deepcopy(cfg)
    bad["data"]["train"]["transforms"] = \
        "pil2np | downscale:40 | totensor | normalize"
    with pytest.raises(ValueError, match="device_scalecrop"):
        build_gan_experiment(bad, device="cpu")
    both = copy.deepcopy(cfg)
    both["learning"]["training"]["epoch_iteration"][
        "cache_teacher_targets"] = True
    with pytest.raises(NotImplementedError, match="cache_teacher_targets"):
        build_gan_experiment(both, device="cpu")
