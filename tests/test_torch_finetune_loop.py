"""The port's fine-tune loop (scenarios/finetune_build.py with
data/mining.py, data/cir_datasets.py, data/datasets.py::Loader,
learning/{training,events,checkpoints}.py) against the JAX package's, on
the CPU, on the same weights and the same seeded images.

The set-up is tests/test_finetune_experiment.py's micro experiment: 16
seeded 48x40 JPEGs in 8 clusters, image_size 32; the published wrapper
chain (meanstd, CLAHE, the md5 gate at 0.25 on the anchor) around a
batch-norm generator of ngf 4 and one block with kaiming_p2p weights and
seeded running statistics; the full GeM-VGG16; neg_num 2, query_size 3,
qpool_size 4, pool_size 12, batch 3, 2 epochs, and finetune.yml's
optimizer (Adam at lr 5e-7, gamma 0.99). Both loops run once (`loops`).
The weights are the port's seeded ones, carried into the JAX variables by
the JAX package's torch importer (`_same_weights`), so the JAX nets are
initialised by shape only: a real init compiles for seconds a net.

XLA's CPU jit moves a uint8 level of the JAX masked CLAHE chain off cv2
(ROADMAP C), and the JAX loop runs that chain jitted; on this set it does
(tests/test_torch_finetune_loop_noclahe.py gives the numbers). So here,
on the published chain, (a) the mined tuples, (b) the loader's batches
and (f) the checkpoint files are held, and the losses and events too;
(c) to (e), the parameters among them, are held without `clahepost` in
that file. At the template's lr 5e-5 a level's worth of gradient
difference, through Adam's sign of each step, moved the weights far
enough apart after one epoch to swap two near-tied negatives of epoch 2;
the published lr keeps the two runs within reach of each other. The
port-only checks of the loop (resume, dispatch_chunk, the miner, Loader,
events and checkpoints at unit level) are
tests/test_torch_finetune_loop_port.py.
"""
import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gandtr_tpu.learning import network as jnetwork
from gandtr_tpu.scenarios import finetune_build as jfb
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.models.init import initialize_weights
from gandtr_tpu_torch.scenarios import finetune_build
from gandtr_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

WRAPPERS = ("meanstd_post:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:"
            "[[0.485,0.456,0.406],[0.229,0.224,0.225]],"
            "clahepost:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:1.0,"
            "cir_ratio_pass_through:0.25:anc")
WRAPPERS_NO_CLAHE = WRAPPERS.replace(
    "clahepost:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:1.0,", "")
LR = 5e-7       # finetune.yml's
GAMMA = 0.99
EPOCHS = 2
RTOL = 1e-4     # (c): each iteration's loss, and events.json's values


def micro_params(wrappers=WRAPPERS, dtype=None):
    return {
        "network": {
            "type": "CirSequentialNetwork", "sequence": "augment,embed",
            "augment": {
                "model": {"architecture": "official_resnet_generator",
                          "ngf": 4, "n_blocks": 1, "norm_layer": "batch",
                          "no_antialias": True, "no_antialias_up": True},
                "runtime": {
                    "frozen": True, "wrappers": wrappers,
                    "data": {"transforms": "pil2np | totensor | normalize",
                             "mean_std": [[0.5] * 3, [0.5] * 3]}}},
            "embed": {
                "model": {"architecture": "cirnet",
                          "cir_architecture": "vgg16", "pooling": "gem",
                          "local_whitening": False, "whitening": False},
                "runtime": {"wrappers": "", "data": {}, "dtype": dtype}},
        },
        "learning": {
            "checkpoints": {"checkpoint_every": 1, "store_every": 2},
            "training": {
                "epochs": EPOCHS, "seed": 0,
                "criterion": {"loss": "contrastive", "margin": 0.75},
                "epoch_iteration": {"type": "SupervisedEpoch",
                                    "batch_average": False,
                                    "fakebatch": True, "data": "train",
                                    "criterion": "default"},
                "optimizer": {"algorithm": "adam", "lr": LR, "beta1": 0.9,
                              "beta2": 0.999, "weight_decay": 0.0005},
                "scheduler": {"algorithm": "gamma", "gamma": GAMMA}},
        },
        "output": {"learning": {"progress": {"print_each": 10}}},
        "data": {"train": {
            "dataset": {"name": "CirDiverseAnchors", "image_size": 32,
                        "neg_num": 2, "pool_size": 12, "query_size": 3,
                        "qpool_size": 4, "similar_exclude": 0.2,
                        "similar_include": 0.8, "split": "train"},
            "loader": {"batch_size": 3, "num_workers": 1}}},
    }


def _synth(root):
    imgdir = root / "ims"
    imgdir.mkdir()
    rng = np.random.RandomState(0)
    images = []
    for i in range(16):
        path = str(imgdir / ("im%02d.jpg" % i))
        Image.fromarray((rng.rand(48, 40, 3) * 255).astype(np.uint8)
                        ).save(path)
        images.append(path)
    db = {"cids": ["im%02d" % i for i in range(16)],
          "cluster": [i // 2 for i in range(16)],     # 8 clusters of 2
          "qidxs": [0, 2, 4, 6], "pidxs": [1, 3, 5, 7]}
    return db, images


def _shape_init(self, rng, x, **kwargs):
    """WrappedNet.init by shape only: zeros, no compile (the weights come
    from the port, `_same_weights`)."""
    shapes = jax.eval_shape(functools.partial(self.module.init, **kwargs),
                            rng, x)
    return jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                  shapes)


def _same_weights(pexp, jexp):
    """The port's seeded GeM-VGG16, and its generator with kaiming_p2p
    weights and seeded running statistics (the seeded normal_p2p generator
    is a chaotic net), carried into the JAX experiment's variables through
    the JAX package's torch importer."""
    gen = pexp["models"]["augment"].module
    initialize_weights(gen, "kaiming_p2p", 0)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, buf in gen.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return {name: jax.tree_util.tree_map(jnp.asarray, ti.convert_torch_state(
        jexp["variables"][name],
        {k: v.numpy() for k, v in m.module.state_dict().items()},
        key_map=ti.key_map_for_architecture(arch), min_coverage=1.0))
        for (name, m), arch in zip(pexp["models"].items(), ("", "cirnet"))}


def _record(rec, training, dataset, embed_params):
    """Record each epoch's tuples, each batch, each loss and the embed
    parameters after each epoch, around the loop's own calls."""
    prepare, to_args, step = (dataset.prepare_epoch,
                              training.loop.batch_to_args,
                              training.loop.step_fn)
    hook = training.state_hook

    def prepare_epoch():
        out = prepare()
        rec["tuples"].append(copy.deepcopy((dataset.tuples,
                                            dataset.tuple_labels)))
        return out

    def batch_to_args(batch):
        rec["batches"].append([np.asarray(a).copy() for a in batch])
        return to_args(batch)

    def step_fn(state, *args):
        state, m = step(state, *args)
        rec["losses"].append(m["total"])
        return state, m

    def state_hook(state, epoch, *rest):
        rec["params"].append(embed_params(state))
        return hook(state, epoch, *rest)

    dataset.prepare_epoch = prepare_epoch
    training.loop.batch_to_args = batch_to_args
    training.loop.step_fn = step_fn
    training.state_hook = state_hook


def _listing(directory):
    """{path under epochs/: symlink target or None}."""
    out = {}
    root = os.path.join(directory, "epochs")
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = (os.readlink(p)
                                             if os.path.islink(p) else None)
    return out


def _port_sd(params):
    return {k: v.detach().clone() for k, v in params.items()}


def _run_pair(root, tag, params, db, images):
    """The JAX loop, then the port's, on the same weights, each recorded."""
    pexp = finetune_build.build_finetune_experiment(
        copy.deepcopy(params), directory=str(root / ("port_" + tag)), db=db,
        images=images, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnetwork.WrappedNet, "init", _shape_init)
        jexp = jfb.build_finetune_experiment(
            copy.deepcopy(params), directory=str(root / ("jax_" + tag)),
            db=db, images=images)
    variables = _same_weights(pexp, jexp)
    jstate = jexp["state"].replace(variables=variables)
    jexp["dataset"].extract_fn.holder["state"] = jstate
    jrec = {k: [] for k in ("tuples", "batches", "losses", "params")}
    _record(jrec, jexp["training"], jexp["dataset"],
            lambda s: from_jax_variables(jax.tree_util.tree_map(
                np.asarray, s.variables["embed"])))
    jexp["training"].run(jstate)
    jrec["losses"] = [float(v) for v in jrec["losses"]]

    prec = {k: [] for k in ("tuples", "batches", "losses", "params")}
    _record(prec, pexp["training"], pexp["dataset"],
            lambda s: _port_sd(dict(s.models["embed"].module
                                    .named_parameters())))
    aug0 = _port_sd(pexp["models"]["augment"].module.state_dict())
    pexp["training"].run(pexp["state"])
    prec["losses"] = [float(v) for v in prec["losses"]]
    return {"jexp": jexp, "jrec": jrec, "jstate": jstate,
            "variables": variables, "pexp": pexp, "prec": prec,
            "aug0": aug0, "jdir": root / ("jax_" + tag),
            "pdir": root / ("port_" + tag)}


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """Both loops on the published chain."""
    root = tmp_path_factory.mktemp("ftloop")
    db, images = _synth(root)
    published = _run_pair(root, "published", micro_params(), db, images)
    return {"db": db, "images": images, "root": root,
            "published": published}


def test_mined_tuples_and_labels_equal_jax(loops):
    """(a) On the published chain, each epoch's (qidxs, pidxs, nidxs) and
    label rows equal the JAX dataset's; every negative is outside its
    query's cluster."""
    run = loops["published"]
    jt, pt = run["jrec"]["tuples"], run["prec"]["tuples"]
    assert len(jt) == len(pt) == EPOCHS
    clusters = loops["db"]["cluster"]
    for (jtup, jlab), (ptup, plab) in zip(jt, pt):
        assert [(int(q), int(p), [int(n) for n in ns]) for q, p, ns in ptup] \
            == [(int(q), int(p), [int(n) for n in ns]) for q, p, ns in jtup]
        assert plab == jlab
        for q, _, ns in ptup:
            assert all(clusters[n] != clusters[q] for n in ns)


def test_loader_batches_equal_jax(loops):
    """(b) On the published chain, the loader's batches in order: the
    uint8 images bit for bit, the sizes, labels and gates."""
    run = loops["published"]
    jb, pb = run["jrec"]["batches"], run["prec"]["batches"]
    assert len(jb) == len(pb) == EPOCHS
    for j, p in zip(jb, pb):
        assert len(j) == len(p) == 4
        for a, b in zip(j, p):
            np.testing.assert_array_equal(b, a)
    assert any(b[3].any() for b in pb), "no tuple took the generator"


def check_losses(run):
    jl, pl = run["jrec"]["losses"], run["prec"]["losses"]
    assert len(jl) == len(pl) == EPOCHS
    np.testing.assert_allclose(pl, jl, rtol=RTOL)


def check_events(run):
    def read(d):
        with open(d / "epochs" / "events.json") as f:
            return json.load(f)
    jev, pev = read(run["jdir"]), read(run["pdir"])
    assert [e["epoch"] for e in pev] == [e["epoch"] for e in jev] == [1, 2]
    for je, pe in zip(jev, pev):
        assert sorted(pe["metrics"]) == sorted(je["metrics"])
        for k, v in je["metrics"].items():
            np.testing.assert_allclose(pe["metrics"][k], v, rtol=RTOL,
                                       err_msg=k)


def test_iteration_losses_equal_jax(loops):
    """(c) Each iteration's loss within 1e-4 relative, on the published
    chain too (held without `clahepost` in
    tests/test_torch_finetune_loop_noclahe.py)."""
    check_losses(loops["published"])


def test_events_equal_jax(loops):
    """(e) events.json: the same epochs and keys, the values within (c)'s
    tolerance, on the published chain too; and the generator untouched."""
    check_events(loops["published"])
    run = loops["published"]
    aug = run["pexp"]["models"]["augment"].module.state_dict()
    assert all(torch.equal(v, run["aug0"][k]) for k, v in aug.items())


def test_checkpoint_files_equal_jax(loops):
    """(f) On the published chain, the epochs/ directory's file names and
    symlink targets equal those of the JAX Checkpoints (checkpoint_every
    1, store_every 2)."""
    run = loops["published"]
    got = _listing(run["pdir"])
    assert got == _listing(run["jdir"])
    assert got["embed_best.ckpt"] == "embed_epoch_02.ckpt"
    assert got["augment_epoch_02.ckpt"] == "augment_frozen.ckpt"


def test_gate_partitioned_extraction_equals_one_batch(loops):
    """The mining extraction splits the gated images from the others and
    scatters the results back: equal to one mixed batch through the chain
    within 1e-5 (float32)."""
    exp = loops["published"]["pexp"]
    idxs = [6, 0, 15, 2, 3, 13]
    got = exp["dataset"].extract_fn(idxs, label="anc-mine")
    gate = [finetune_build.cir_hash_passthrough(
        finetune_build.metadata_name(loops["images"][i]), 0.25)
        for i in idxs]
    assert 0 < sum(gate) < len(idxs)
    imgs, hws = zip(*(finetune_build.load_u8_padded(loops["images"][i], 32,
                                                    32) for i in idxs))
    with torch.no_grad():
        x, m = exp["stage"](torch.from_numpy(np.stack(imgs))[None],
                            torch.from_numpy(np.asarray(hws, np.int32))[None])
        y, m = exp["models"]["augment"].apply(
            x[0], ctx={"pass_mask": torch.tensor(gate)}, train=True,
            mask=m[0])
        want = exp["models"]["embed"].apply(y, train=False, mask=m).numpy()
    np.testing.assert_allclose(got, want.T, rtol=0, atol=1e-5)


def test_chip_smoke_loop_config_is_the_published_one():
    """chip_smoke.py's loop runs finetune.yml as published but for the
    cuts it names: the checkpoints out of reach and the embed in bf16 (as
    its step phase), 2 epochs, query_size 20, qpool_size 40, pool_size 150,
    checkpoint_every 1, store_every 2, and the synthetic tuple set."""
    import yaml

    import chip_smoke
    with open("gandtr_tpu/scenarios/configs/iccv23/parameters/"
              "finetune.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["network"]["augment"]["path"] = None
    cfg["network"]["embed"]["model"]["pretrained"] = False
    cfg["network"]["embed"]["runtime"]["dtype"] = "bfloat16"
    cfg["learning"]["training"]["epochs"] = 2
    cfg["learning"]["checkpoints"].update(checkpoint_every=1, store_every=2)
    cfg["data"]["train"]["dataset"].update(
        query_size=20, qpool_size=40, pool_size=150, dataset_pkl="db.pkl",
        image_dir="ims")
    assert chip_smoke.finetune_loop_config("db.pkl", "ims") == cfg


def test_entry_point_raises_without_cuda(monkeypatch, tmp_path):
    """The loop's entry point runs on cuda unless asked for the CPU: with
    a database and a directory and no GPU it raises before building."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db, images = _synth(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune_build.build_finetune_experiment(
            micro_params(), str(tmp_path / "exp"), db, images)
    assert not (tmp_path / "exp").exists()
