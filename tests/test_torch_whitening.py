"""The port's whitening learning (ops/whiten.py), the infer stage's
embedding output (scenarios/infer_stage.py::infer) and the multistep stage
(scenarios/multistep_stage.py::infer_and_learn_whitening, step 2 of
`finetune_r101`) against the JAX package's, on the CPU.

The net is a reduced-depth GeM ResNet (tests/test_torch_resnet.py's
RESNET_T: blocks (1, 1, 2, 1), 2048-d) with the port's seeded weights; the
JAX stages load them as a reference-format .pth, the port's stages as the
port's own network file (`epochs/embed_best.ckpt`, written by its
Checkpoints), as steps 2 and 4 of `finetune_r101` do. The images are
seeded synthetic photos in the reference's cid tree. The JAX chains run
their CLAHE on the host, eagerly (`device_preprocess: false`), as
tests/test_torch_eval.py runs them. The validate stage of `eval_r101` is
tests/test_torch_eval_r101.py.

Tolerances: 1e-10 for the float64 whitening learning on equal input; 1e-4
on unit-norm float32 descriptors; 1e-3 on the whitened descriptors, each
stage's learned Lw applied to its own descriptors: Lw learned from a few
pairs of 2048-d descriptors is ill-conditioned (the pairs' covariance has
rank 6 and takes a jitter), so the descriptors' 1e-5 parts grow there."""
import copy
import functools
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gandtr_tpu.ops import whiten as jwhiten
from gandtr_tpu.scenarios import multistep_stage as jmultistep
from gandtr_tpu_torch.learning.checkpoints import Checkpoints
from gandtr_tpu_torch.learning.training import Training
from gandtr_tpu_torch.ops import whiten as twhiten
from gandtr_tpu_torch.scenarios import infer_stage as tinfer
from gandtr_tpu_torch.scenarios import multistep_stage as tmultistep
from test_torch_eval import _image
from test_torch_resnet import MODEL, RESNET_T, reduced_resnet, seeded_net

torch.set_num_threads(1)

IMNET = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
TRANSFORMS = "pil2np | apply_clahe:1.0 | totensor | normalize"
R_MODEL = dict(MODEL, cir_architecture=RESNET_T)
N_WHITEN = 12                   # images of the whitening set
QIDXS, PIDXS = [0, 2, 4, 6, 8, 10], [1, 3, 5, 7, 9, 11]
WHITEN_SHAPES = [(64, 48), (50, 64), (80, 60), (40, 40), (64, 64),
                 (90, 70)]
__all__ = ["reduced_resnet"]    # the module-scoped RESNET_T fixture


# ---- the float64 learning

def _descriptors(D=32, N=40, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(D, N)
    return X / np.linalg.norm(X, axis=0)


@pytest.mark.parametrize("shrink", [None, 5])
def test_pcawhitenlearn_equals_jax(shrink):
    X = _descriptors()
    for got, want in zip(twhiten.pcawhitenlearn(X, shrink),
                         jwhiten.pcawhitenlearn(X, shrink)):
        np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)


@pytest.mark.parametrize("pairs", [20, 5])
def test_whitenlearn_equals_jax(pairs):
    """20 pairs of 32-d descriptors, and 5 (a singular covariance: the
    jittered Cholesky)."""
    X = _descriptors()
    q, p = list(range(pairs)), list(range(pairs, 2 * pairs))
    for got, want in zip(twhiten.whitenlearn(X, q, p),
                         jwhiten.whitenlearn(X, q, p)):
        np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)


def test_jittered_cholesky_equals_jax():
    X = _descriptors(D=8, N=3)
    S = X @ X.T
    np.testing.assert_allclose(twhiten._jittered_cholesky(S),
                               jwhiten._jittered_cholesky(S), atol=1e-10,
                               rtol=0)


def test_whitenlearn_with_retry_equals_jax(monkeypatch):
    """Equal on the first trial, and on a retry: the first ten trials fail
    in both packages, and the eleventh learns from the same random subset
    of 18 pairs."""
    X = _descriptors()
    q, p = list(range(20)), list(range(20, 40))
    for got, want in zip(twhiten.whitenlearn_with_retry(X, q, p),
                         jwhiten.whitenlearn_with_retry(X, q, p)):
        np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)

    def failing(module):
        real, calls = module.whitenlearn, []

        def whitenlearn(X, qidxs, pidxs):
            calls.append(list(qidxs))
            if len(calls) < 11:
                raise np.linalg.LinAlgError("forced")
            return real(X, qidxs, pidxs)
        monkeypatch.setattr(module, "whitenlearn", whitenlearn)
        return calls

    tcalls, jcalls = failing(twhiten), failing(jwhiten)
    got = twhiten.whitenlearn_with_retry(X, q, p, seed=3)
    want = jwhiten.whitenlearn_with_retry(X, q, p, seed=3)
    assert tcalls == jcalls and len(tcalls[10]) == 18
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-10, rtol=0)


# ---- the stages

def write_network_files(root, net, model):
    """The net as a reference .pth (for the JAX stages) and as the port's
    `epochs/embed_best.ckpt`, written by the port's Checkpoints from a
    Training's network file (for the port's). Returns (pth, ckpt)."""
    pth = os.path.join(root, "net.pth")
    torch.save({"model_state": net.state_dict(),
                "network_params": {"model": model}}, pth)
    training = Training(step_fn=None, loader=None, epochs=1,
                        net_params={"embed": {"model": model, "runtime": {
                            "wrappers": "cirfaketuplebatch"}}})
    Checkpoints(root).save_epoch(1, {"embed": training._net_file(
        SimpleNamespace(models={"embed": SimpleNamespace(module=net)}),
        "embed")}, is_best=True, is_last=True)
    return pth, os.path.join(root, "epochs", "embed_best.ckpt")


def write_whiten_set(root, seed=1):
    """N_WHITEN photos in the reference's cid tree under root/ims and the
    whitening pickle {"cids", "qidxs", "pidxs"} (each query's positive is
    the next photo, of its group)."""
    rng = np.random.RandomState(seed)
    cids = []
    for i in range(N_WHITEN):
        cid = "%08x%s" % (0x1a2b3c4d + 977 * i, "f" * 24)
        sub = os.path.join(root, "ims", cid[-2:], cid[-4:-2], cid[-6:-4])
        os.makedirs(sub, exist_ok=True)
        h, w = WHITEN_SHAPES[i % len(WHITEN_SHAPES)]
        _image(rng, h, w, (i // 2) % 3).save(os.path.join(sub, cid),
                                               format="JPEG")
        cids.append(cid)
    path = os.path.join(root, "retrieval-SfM-120k-whiten.pkl")
    with open(path, "wb") as f:
        pickle.dump({"cids": cids, "qidxs": QIDXS, "pidxs": PIDXS}, f)
    return path


def whitening_params(net_path, whiten_pkl, image_dir, directory,
                     model=R_MODEL):
    """whitening.yml's sections at a test size (image_size 64) for a
    2048-d net, as finetune_r101's step 2 sets them."""
    return {
        "whitening": {"type": "lw", "dataset_pkl": whiten_pkl,
                      "directory": directory},
        "network": {"type": "SingleNetwork", "path": net_path,
                    "model": dict(model),
                    "runtime": {"wrappers": "cirmultiscale:True"}},
        "data": {"image_dir": image_dir + "/*", "image_size": 64,
                 "shape_bucket": 64, "transforms": TRANSFORMS,
                 "mean_std": IMNET},
        "output": {"dimensions": 2048},
    }


def _jax_host(params):
    """The JAX stage's sections with its CLAHE on the host, one device."""
    params = copy.deepcopy(params)
    params["data"].update(device_preprocess=False, parallel_extract=False)
    return params


@pytest.fixture(scope="module")
def stages(tmp_path_factory, reduced_resnet):
    """Both packages' multistep stage from the same weights, and the
    descriptors each extracted."""
    root = str(tmp_path_factory.mktemp("r101_chain"))
    net = seeded_net(R_MODEL, seed=2).eval()
    pth, ckpt = write_network_files(root, net, R_MODEL)
    whiten_pkl = write_whiten_set(root)
    image_dir = os.path.join(root, "ims")
    out = {"root": root, "ckpt": ckpt, "whiten_pkl": whiten_pkl}
    for tag, mod, path in (("jax", jmultistep, pth),
                           ("port", tmultistep, ckpt)):
        directory = os.path.join(root, tag)
        params = whitening_params(path, whiten_pkl, image_dir, directory)
        if tag == "jax":
            params = _jax_host(params)
            run = functools.partial(mod.infer_and_learn_whitening, params, ())
        else:
            run = functools.partial(mod.infer_and_learn_whitening, params,
                                    None, device="cpu")
        recorded = []
        infer = _recording_infer(tag, recorded)
        (meta,) = infer(run)
        out[tag] = {"meta": meta, "vecs": recorded[0],
                    "params": params, "run": run}
        with open(meta["whitening_path"], "rb") as f:
            out[tag]["lw"] = pickle.load(f)
    return out


def _recording_infer(tag, recorded):
    """run() while the stage's infer records the descriptors it returns."""
    from gandtr_tpu.scenarios import infer_stage as jinfer
    module = jinfer if tag == "jax" else tinfer

    def call(run):
        original = module.infer

        def infer(*args, **kwargs):
            (meta,) = original(*args, **kwargs)
            recorded.append(np.array(meta["vecs"]))
            return (meta,)
        module.infer = infer
        if tag == "port":
            tmultistep.infer = infer
        try:
            return run()
        finally:
            module.infer = original
            if tag == "port":
                tmultistep.infer = original
    return call


def test_whitening_descriptors_match_jax(stages):
    want, got = stages["jax"]["vecs"], stages["port"]["vecs"]
    assert got.shape == want.shape == (2048, N_WHITEN)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_whitened_descriptors_match_jax(stages):
    """Each stage's Lw pickle (m (2048, 1), P (2048, 2048)) applied to its
    own descriptors."""
    out = []
    for tag in ("jax", "port"):
        lw, X = stages[tag]["lw"], stages[tag]["vecs"]
        assert lw["P"].shape == (2048, 2048) and lw["m"].shape == (2048, 1)
        out.append(twhiten.whitenapply(
            torch.from_numpy(X.astype(np.float64)),
            torch.from_numpy(lw["m"]), torch.from_numpy(lw["P"])).numpy())
    np.testing.assert_allclose(out[1], out[0], atol=1e-3, rtol=0)


def test_whitening_pickle_path_and_skip(stages):
    """`<directory>/whitening/lw-retrieval.pkl` in both packages; a second
    run finds it and skips."""
    for tag in ("jax", "port"):
        path = stages[tag]["meta"]["whitening_path"]
        assert path == os.path.join(stages["root"], tag, "whitening",
                                    "lw-retrieval.pkl")
        (again,) = stages[tag]["run"]()
        assert again == {"status": "skipped", "whitening_path": path}
    assert stages["port"]["meta"]["infer"]["count"] == N_WHITEN


def test_without_directory_returns_the_whitening(stages, monkeypatch):
    """No directory: nothing is written, and the whitening comes back (the
    Lw of the stage's own descriptors). The stage's infer hands back the
    descriptors the module fixture's run of the same stage recorded, and
    the Lw that run learned from them is the one expected."""
    params = copy.deepcopy(stages["port"]["params"])
    params["whitening"]["directory"] = None

    def recorded_infer(infer_params, data, device=None):
        assert infer_params["output"]["type"] == "embedding"
        assert len(data[0]) == stages["port"]["vecs"].shape[1]
        return ({"vecs": stages["port"]["vecs"].copy(),
                 "names": list(data[0]), "count": len(data[0])},)
    monkeypatch.setattr(tmultistep, "infer", recorded_infer)
    (meta,) = tmultistep.infer_and_learn_whitening(params, None,
                                                   device="cpu")
    assert meta["whitening_path"] is None
    # the Lw of those descriptors: the one the fixture's run learned
    m, P = stages["port"]["lw"]["m"], stages["port"]["lw"]["P"]
    np.testing.assert_allclose(meta["whitening"]["m"], m, atol=1e-10)
    np.testing.assert_allclose(meta["whitening"]["P"], P, atol=1e-10)
    params["whitening"]["type"] = "itq"
    with pytest.raises(ValueError, match="itq"):
        tmultistep.infer_and_learn_whitening(params, None, device="cpu")


def test_infer_embedding_in_name_order(stages):
    """The infer stage on names of two buckets, in an order that is not
    the buckets': columns in the names' order, each equal to the image's
    descriptor alone, bucketed equal to exact within 1e-5; an image
    output refuses the shape bucket."""
    params = copy.deepcopy(stages["port"]["params"])
    params.pop("whitening")
    params["output"] = {"type": "embedding"}
    with open(stages["whiten_pkl"], "rb") as f:
        cids = pickle.load(f)["cids"]
    names = ["/".join([c[-2:], c[-4:-2], c[-6:-4], c])
             for c in (cids[5], cids[0], cids[3])]
    (meta,) = tinfer.infer(params, (names,), device="cpu")
    assert meta["names"] == names and meta["count"] == 3
    alone = np.concatenate([tinfer.infer(params, ([n],), device="cpu")[0]
                            ["vecs"] for n in names], axis=1)
    np.testing.assert_allclose(meta["vecs"], alone, atol=1e-6, rtol=0)
    params["data"]["shape_bucket"] = None
    (exact,) = tinfer.infer(params, (names,), device="cpu")
    np.testing.assert_allclose(meta["vecs"], exact["vecs"], atol=1e-5,
                               rtol=0)
    # an image output takes no shape bucket (it would keep the pad band)
    params["data"]["shape_bucket"] = 64
    params["output"] = {"type": "image", "directory": stages["root"]}
    with pytest.raises(ValueError, match="embedding output"):
        tinfer.infer(params, (names,), device="cpu")
