"""The port's fine-tune loop on its own, on the CPU: resume, the chunked
loop, mining after a step, and the loop's modules (miner, partial-rank
search, datasets, Loader, events, checkpoints) against the JAX package's
at unit level. The loops against the JAX loops are
tests/test_torch_finetune_loop.py (the published chain) and
tests/test_torch_finetune_loop_noclahe.py; this file runs no JAX loop,
so each of the three stays within a worker's minute.
"""
import copy
import os
import shutil

import numpy as np
import pytest
import torch

from gandtr_tpu_torch.data import mining
from gandtr_tpu_torch.data.cir_datasets import (cir_diverse_anchors_dataset,
                                                cir_tuples_dataset)
from gandtr_tpu_torch.data.datasets import Loader
from gandtr_tpu_torch.scenarios import finetune_build
from test_torch_finetune_loop import _listing, _synth, micro_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The port's micro loop, 2 epochs, with its state after epoch 1 and a
    copy of its directory as it was then."""
    root = tmp_path_factory.mktemp("ftloop_port")
    db, images = _synth(root)
    exp = finetune_build.build_finetune_experiment(
        micro_params(), directory=str(root / "exp"), db=db, images=images,
        device="cpu")
    after1 = {}
    hook = exp["training"].state_hook

    def snapshot(state, epoch):
        if epoch == 1:
            after1.update(
                params={k: p.detach().clone() for k, p in
                        state.models["embed"].module.named_parameters()},
                optimizer=copy.deepcopy(state.optimizer.state_dict()),
                step=state.step,
                events=copy.deepcopy(exp["events"].state_dict()))
            shutil.copytree(root / "exp", root / "after1", symlinks=True)
        return hook(state, epoch)

    exp["training"].state_hook = snapshot
    exp["training"].run(exp["state"])
    return {"db": db, "images": images, "root": root, "after1": after1}


def test_resume_restores_the_state_bit_for_bit(straight):
    """A fresh experiment on the directory as it was after epoch 1 resumes
    at epoch 2 with the straight run's parameters, Adam moments, step and
    events, bit for bit, and trains epoch 2 to a finite loss. Its miner and
    loader restart from their seeds (the JAX package's resume restores
    neither; ROADMAP C)."""
    params = micro_params()
    exp = finetune_build.build_finetune_experiment(
        params, directory=str(straight["root"] / "after1"),
        db=straight["db"], images=straight["images"], device="cpu")
    state, start = exp["training"].resume_or_start(exp["state"])
    after1 = straight["after1"]
    assert start == 2 and state.step == after1["step"] == 1
    for k, p in state.models["embed"].module.named_parameters():
        assert torch.equal(p.detach(), after1["params"][k]), k
    got, want = state.optimizer.state_dict(), after1["optimizer"]
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    assert exp["events"].state_dict() == after1["events"]
    fresh = np.random.RandomState(0).get_state()
    for rs in (exp["dataset"].miner.rng, exp["loader"].rng):
        assert all(np.array_equal(a, b) for a, b in
                   zip(rs.get_state()[1:3], fresh[1:3]))
    state = exp["training"].run(state, start_epoch=start)
    hist = exp["events"].history
    assert [e["epoch"] for e in hist] == [1, 2]
    assert np.isfinite(hist[1]["metrics"]["train/learning/total"])

    changed = copy.deepcopy(params)
    changed["data"]["train"]["dataset"]["pool_size"] = 10
    exp = finetune_build.build_finetune_experiment(
        changed, directory=str(straight["root"] / "after1"),
        db=straight["db"], images=straight["images"], device="cpu")
    with pytest.raises(RuntimeError, match="resume config mismatch"):
        exp["training"].resume_or_start(exp["state"])


def test_dispatch_chunk_gives_the_same_state(straight):
    """dispatch_chunk 2 (two steps, then one read-back) against 0 over an
    epoch of three steps: the same parameters, moments and losses, bit for
    bit."""
    runs = []
    for chunk in (0, 2):
        params = micro_params()
        params["learning"]["training"].update(epochs=1, dispatch_chunk=chunk)
        params["data"]["train"]["loader"]["batch_size"] = 1
        exp = finetune_build.build_finetune_experiment(
            params, db=straight["db"], images=straight["images"],
            device="cpu")
        assert exp["loader"].prefetch == (4 if chunk else 2)
        state = exp["training"].run(exp["state"])
        runs.append((dict(state.models["embed"].module.named_parameters()),
                     copy.deepcopy(state.optimizer.state_dict()),
                     exp["events"].history, state.step))
    (p0, o0, h0, s0), (p1, o1, h1, s1) = runs
    assert s0 == s1 == 3 and h0 == h1
    assert all(torch.equal(p1[k], v) for k, v in p0.items())
    for i, s in o0["state"].items():
        assert all(torch.equal(o1["state"][i][k], v) for k, v in s.items())


def test_extraction_follows_the_stepped_weights(straight):
    """Mining after an optimizer step equals mining by a fresh net loaded
    with the stepped weights: the embed in bf16 (conv1_2 / conv2_2 through
    K2's plain version) runs a cached cast copy of its parameters
    (WrappedNet.compute_module), which the step must invalidate."""
    params = micro_params(dtype="bfloat16")
    exp = finetune_build.build_finetune_experiment(
        params, db=straight["db"], images=straight["images"], device="cpu")
    idxs = [0, 6, 9]
    before = exp["dataset"].extract_fn(idxs, label="anc-mine")
    exp["dataset"].prepare_epoch()
    batch = next(iter(exp["loader"]))
    state, _ = exp["step"](exp["state"], *(torch.from_numpy(a)
                                           for a in batch))
    after = exp["dataset"].extract_fn(idxs, label="anc-mine")
    fresh = finetune_build.build_finetune_experiment(
        params, db=straight["db"], images=straight["images"], device="cpu")
    fresh["models"]["embed"].module.load_state_dict(
        exp["models"]["embed"].module.state_dict())
    want = fresh["dataset"].extract_fn(idxs, label="anc-mine")
    assert not np.array_equal(after, before)
    np.testing.assert_array_equal(after, want)


def test_partial_rank_search_equals_the_full_search():
    """search_hard_negatives reads the device ranks a few leading rows at a
    time; on seeded descriptors with big clusters (a query's own cluster
    fills its top ranks, so the rows widen) its picks and distances equal
    the JAX package's search over the whole rank matrix."""
    from gandtr_tpu.data.mining import search_hard_negatives as j_search
    rng = np.random.RandomState(7)
    clusters = list(np.repeat(np.arange(30), 10))     # 30 clusters of 10
    centers = rng.randn(64, 30)
    vecs = centers[:, clusters] + 0.3 * rng.randn(64, 300)
    vecs = (vecs / np.linalg.norm(vecs, axis=0)).astype(np.float32)
    qidxs = list(rng.choice(300, 40, replace=False))
    pool = list(rng.permutation(300)[:250])
    qvecs, poolvecs = vecs[:, qidxs], vecs[:, pool]
    want, wstats = j_search(qvecs, poolvecs, qidxs, pool, clusters, 5)
    for lead in (1, 3, 64):
        got, stats = mining.search_hard_negatives(
            qvecs, poolvecs, qidxs, pool, clusters, 5, device="cpu",
            lead=lead)
        assert got == want
        np.testing.assert_allclose(stats["average_negative_distance"],
                                   wstats["average_negative_distance"],
                                   rtol=1e-6)
    few = [i for i in pool if clusters[i] < 4]        # 4 clusters only
    with pytest.raises(IndexError, match="fewer than"):
        mining.search_hard_negatives(qvecs, vecs[:, few], qidxs, few,
                                     clusters, 5, device="cpu")


def test_miner_and_selection_equal_jax():
    """TuplesMiner on seeded descriptors (an extract_fn that looks them
    up), diverse and random-query, against the JAX miner: the same tuples,
    labels and stats."""
    from gandtr_tpu.data.mining import TuplesMiner as JMiner
    rng = np.random.RandomState(11)
    vecs = rng.randn(32, 60).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=0)
    db = {"cids": ["c%02d" % i for i in range(60)],
          "cluster": [i // 3 for i in range(60)],
          "qidxs": list(range(0, 60, 3)), "pidxs": list(range(1, 60, 3))}

    def extract(idxs, label="anc-mine"):
        return vecs[:, list(idxs)]

    for kw in ({"qpool_size": 12, "similar_exclude": 0.2,
                "similar_include": 0.8, "mark_easy": 0.5},
               {"first_neg": "pos"}, {}):
        common = dict(nnum=3, qsize=8, poolsize=40, seed=4, **kw)
        want = JMiner(db, **common).create_epoch_tuples(extract)
        got = mining.TuplesMiner(db, device="cpu",
                                 **common).create_epoch_tuples(extract)
        assert got[:4] == want[:4]
        assert got[4].keys() == want[4].keys()
        for k in want[4]:
            np.testing.assert_allclose(got[4][k], want[4][k], rtol=1e-6)


def test_dataset_factories_and_loader(tmp_path):
    """cir_tuples_dataset / cir_diverse_anchors_dataset from a pkl in the
    `ids` form, and the Loader's order, drop_last and prefetching threads
    against the JAX Loader."""
    import pickle
    from gandtr_tpu.data.datasets import Loader as JLoader
    db, images = _synth(tmp_path)
    ids = [os.path.basename(p) for p in images]
    pkl = tmp_path / "db.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"train": {k: v for k, v in db.items() if k != "cids"}
                     | {"ids": ids}}, f)
    base = {"dataset_pkl": str(pkl), "split": "train",
            "image_dir": str(tmp_path / "ims"), "image_size": 32,
            "neg_num": 2, "query_size": 3, "pool_size": 12}
    with pytest.raises(ValueError, match="unused"):
        cir_tuples_dataset(**dict(base, bogus=1))
    ds = cir_tuples_dataset(**dict(base, query_size=float("inf")))
    assert ds.miner.qsize == 4 and ds.miner.num_images == 16
    assert not ds.miner.diverse and ds.images == images
    div = cir_diverse_anchors_dataset(**dict(base, qpool_size=4))
    assert div.miner.diverse and div.miner.qpool_size == 4
    assert div.pad_size == 32

    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return (np.full((2,), i), np.asarray([i * 2]))

    for workers in (1, 3):
        for shuffle, drop in ((True, True), (False, False)):
            kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop,
                      num_workers=workers, seed=5, prefetch=1)
            mine, theirs = Loader(Items(), **kw), JLoader(Items(), **kw)
            got = [b for _ in range(2) for b in mine]
            want = [b for _ in range(2) for b in theirs]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)


def test_events_and_histograms_against_jax(tmp_path):
    """The event broker against the JAX one on the same events: history,
    metadata (best epoch under a loss criterion), histograms, the SVG
    files, and a state_dict round trip; then blobs (an image, a gray map,
    text) and heatmaps (the GAN paths' sample images) written as the same
    files with the same bytes, the HTML report (the `htmlreport`
    processor) with the same document, and the `tensorboard` processor's
    event file.""" 
    from gandtr_tpu.learning import events as jev
    from gandtr_tpu_torch.learning import events as pev
    rng = np.random.RandomState(2)
    brokers = []
    for mod, sub in ((jev, "j"), (pev, "p")):
        b = mod.initialize_processor({"progress": {"print_each": None}},
                                     directory=str(tmp_path / sub),
                                     decisive_criterion="val/loss")
        brokers.append(b)
    for epoch in (1, 2, 3):
        vals = rng.rand(4)
        w = rng.randn(50)
        for b in brokers:
            log = b.logger("train", epoch, 4)
            for i, v in enumerate(vals):
                log("loss", float(v), "scalar/loss", iteration=i)
                log("time", float(v), "scalar/time", iteration=i)
            log("w", {"a": w}, "weight/param")
            b.logger("", epoch)("val/loss", float(3 - epoch % 2),
                                "scalar/loss")
            b.close_epoch(epoch)
    jb, pb = brokers
    assert pb.history == jb.history
    assert pb.metadata.state_dict() == jb.metadata.state_dict()
    assert pb.metadata.best_epoch() == jb.metadata.best_epoch() == 1
    assert pb.metadata.is_last_best() == jb.metadata.is_last_best()
    assert _listing(tmp_path / "p") == _listing(tmp_path / "j")
    for name in os.listdir(tmp_path / "j" / "epochs" / "blobs"):
        if name.endswith(".svg"):
            assert (tmp_path / "p" / "epochs" / "blobs" / name).read_text() \
                == (tmp_path / "j" / "epochs" / "blobs" / name).read_text()
    fresh = pev.initialize_processor({}, decisive_criterion=None)
    fresh.load_state_dict(pb.state_dict())
    assert fresh.state_dict() == pb.state_dict()
    img = rng.rand(24, 24, 3).astype(np.float32)
    for b in brokers:
        log = b.logger("", 4)
        log("data/real_X/image0.rgb", img, "blob")
        log("data/real_E/image0.chan1", img[..., 0], "blob")
        log("data/labels", "[1, 2]", "blob")
        log("val/loss_map", {"a": img[..., 1]}, "heatmap")
        log("val/edges", img[..., 2], "heatmap")
    for name in os.listdir(tmp_path / "j" / "epochs" / "blobs"):
        assert (tmp_path / "p" / "epochs" / "blobs" / name).read_bytes() \
            == (tmp_path / "j" / "epochs" / "blobs" / name).read_bytes(), name
    assert _listing(tmp_path / "p") == _listing(tmp_path / "j")
    reports, ws = [], rng.randn(2, 20)
    for mod, sub in ((jev, "jr"), (pev, "pr")):
        b = mod.initialize_processor({"htmlreport": {}},
                                     directory=str(tmp_path / sub))
        for epoch in (1, 2):
            log = b.logger("train", epoch, 2)
            for i in range(2):
                log("loss", float(epoch + i), "scalar/loss", iteration=i)
            log("w", {"a": ws[epoch - 1]}, "weight/param")
            b.logger("", epoch)("val/visual/v0", img, "blob")
            b.close_epoch(epoch)
        reports.append((tmp_path / sub / "epochs" / "htmlreport" /
                        "index.html").read_text())
    assert reports[1] == reports[0] and "val_visual_v0_epoch_02.jpg" in \
        reports[1]
    # the `tensorboard` processor: an event-file writer streaming under
    # epochs/tensorboard in both (tests/test_torch_finetune_validation.py
    # holds its records to the JAX writer's)
    for mod, sub in ((jev, "jt"), (pev, "pt")):
        b = mod.initialize_processor({"tensorboard": {}},
                                     directory=str(tmp_path / sub))
        assert [type(s).__name__ for s in b.streamers] == \
            ["TensorboardWriter"]
        assert len(os.listdir(tmp_path / sub / "epochs" / "tensorboard")) \
            == 1


def test_checkpoint_gc_and_adoption_against_jax(tmp_path):
    """The Checkpoints file logic against the JAX class over 7 epochs
    (checkpoint_every 2, store_every 3, best at epochs 1, 2 and 5): the
    same files and symlink targets after every epoch; then a sibling
    experiment with more epochs adopts the finished one."""
    from gandtr_tpu.learning.checkpoints import Checkpoints as JCk
    from gandtr_tpu_torch.learning.checkpoints import Checkpoints as PCk
    jck = JCk(str(tmp_path / "j"), store_every=3, checkpoint_every=2)
    pck = PCk(str(tmp_path / "p"), store_every=3, checkpoint_every=2)
    for epoch in range(1, 8):
        best = epoch in (1, 2, 5)
        last = epoch == 7
        jck.save_epoch(epoch, {"embed": {"w": np.full(3, epoch, np.float32)},
                               "augment": {"w": np.zeros(2, np.float32)}},
                       train_state={"epoch": epoch}, frozen=("augment",),
                       is_best=best, is_last=last)
        pck.save_epoch(epoch, {"embed": {"model_state": {
            "w": torch.full((3,), float(epoch))}},
            "augment": {"model_state": {"w": torch.zeros(2)}}},
            train_state={"epoch": epoch}, frozen=("augment",),
            is_best=best, is_last=last)
        assert _listing(tmp_path / "p") == _listing(tmp_path / "j"), epoch
    assert pck.load_latest_epoch() == (7, {"epoch": 7})
    assert float(pck.load_net("embed", "_best")["model_state"]["w"][0]) == 5
    sib = PCk(str(tmp_path / "exp_9"), directory_epoch_regex=None)
    src = PCk(str(tmp_path / "exp_3"), store_every=0, checkpoint_every=1)
    for epoch in range(1, 4):
        src.save_epoch(epoch, {"embed": {"model_state": {
            "w": torch.full((1,), float(epoch))}}},
            train_state={"epoch": epoch}, is_best=True, is_last=epoch == 3)
    sib.directory_epoch_regex = r"(.*exp_)(\d+)(/epochs)"
    epoch, meta = sib.load_latest_epoch()
    assert (epoch, meta) == (3, {"epoch": 3})
    assert float(sib.load_net("embed", 3)["model_state"]["w"][0]) == 3
    assert os.path.isfile(tmp_path / "exp_9" / "epochs" / "embed_best.ckpt")


@pytest.mark.parametrize("frequency", [None, 0, 1, 5])
def test_should_validate_matches_jax(frequency):
    from gandtr_tpu.learning.training import should_validate as j_should
    from gandtr_tpu_torch.learning.training import should_validate
    for epoch in (None, 1, 2, 5, 10):
        assert should_validate(frequency, epoch) == j_should(frequency, epoch)
