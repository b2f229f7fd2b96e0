"""The port's scenario runner (scenarios/run.py::run_target) against the
JAX package's on tests/test_all_target_chain.py's micro `all` target and
synthetic set, on the CPU: a CycleGAN (ngf 4, one block) trained one
step, its generator's images written (the `output` step), a VGG16 GeM
fine-tune with that generator as augmentation, Lw whitening learned on
the fine-tuned net, and the retrieval eval with that Lw.

The JAX GAN nets start from seeded values over their shapes
(tests/torch_gan_common.py); the JAX embed from its own init. Those
initial weights reach the port's scenario as local `pretrained:` files.
Each step is held to the bound of the port's own tests of that stage:
the GAN's events within 1e-3; the output images with JAX's names, within
one uint8 level; the fine-tune's losses within 1e-4 and embed_best.ckpt
within Adam's 2 lr a step; the whitening descriptors within 1e-4 and
the Lw learning within 1e-10 on them; the eval's mAPs equal; every
step's metadata with JAX's keys. Where the two chains' weights part by
Adam's first-step sign flips, the test names the share it allows.
"""
import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

import gandtr_tpu.scenarios.build as jbuild
import gandtr_tpu.scenarios.finetune_build as jfb
from gandtr_tpu.learning.checkpoints import load_network_file
from gandtr_tpu.scenarios import infer_stage as jinfer
from gandtr_tpu.scenarios import run as jrun
from gandtr_tpu_torch.scenarios import infer_stage as tinfer
from gandtr_tpu_torch.scenarios import multistep_stage as tmultistep
from gandtr_tpu_torch.scenarios import run
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_all_target_chain import synth
from torch_gan_common import shape_init

torch.set_num_threads(1)

__all__ = ["synth"]
NAMES = ["i%d.jpg" % i for i in range(4)]
GAN_NETS = ("generator_X", "generator_Y", "discriminator_X",
            "discriminator_Y")
FT_LR = 5e-5


def chain_scenario(d, out):
    """tests/test_all_target_chain.py's scenario, its outputs under
    `out`."""
    exp_gan, exp_ft = os.path.join(out, "exp_gan"), os.path.join(out,
                                                                 "exp_ft")
    mean_std_gan = [[0.5] * 3, [0.5] * 3]
    imnet = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
    gen_model = {"architecture": "official_resnet_generator",
                 "ngf": 4, "n_blocks": 1, "norm_layer": "instance"}
    disc_model = {"architecture": "official_p2p_discriminator",
                  "ndf": 4, "n_layers": 2, "norm_layer": "instance"}
    cir = {"architecture": "cirnet", "cir_architecture": "vgg16",
           "pooling": "gem", "local_whitening": False, "whitening": False}
    ft_dir = "${3_finetune.parameters.learning.checkpoints.directory}"
    gan_dir = "${1_train_gan.parameters.learning.checkpoints.directory}"
    return {"all": {
        "__doc__": "micro all-target chain",
        "1_train_gan": {
            "__function__": "gandtr_tpu.stages.train",
            "sample_hw": 32,
            "network": {
                "type": "NetworkSet",
                "generator_X": {"model": dict(gen_model), "runtime": {
                    "wrappers": "", "data": {
                        "transforms": "pil2np | scalecrop:32_32:0.8_1 | "
                                      "totensor | normalize",
                        "mean_std": mean_std_gan}}},
                "generator_Y": {"model": dict(gen_model),
                                "runtime": {"wrappers": "", "data": {}}},
                "discriminator_X": {"model": dict(disc_model),
                                    "runtime": {"wrappers": "", "data": {}}},
                "discriminator_Y": {"model": dict(disc_model),
                                    "runtime": {"wrappers": "", "data": {}}},
            },
            "learning": {
                "checkpoints": {"directory": exp_gan,
                                "store_every": 1, "checkpoint_every": 1},
                "training": {
                    "type": "EpochTraining", "epochs": 1, "seed": 0,
                    "criterion": {
                        "loss": "cycle_loss",
                        "loss_G_X": {"weights": {"adversarial": 1,
                                                 "cycle": 10}},
                        "loss_G_Y": {"weights": {"adversarial": 1,
                                                 "cycle": 10}},
                    },
                    "optimizer": {n: {"algorithm": "adam", "lr": 2e-4,
                                      "beta1": 0.5} for n in GAN_NETS},
                    "scheduler": {n: {"algorithm": "lambda_p2p",
                                      "n_epochs_decay": 1}
                                  for n in GAN_NETS},
                    "epoch_iteration": {"type": "SupervisedCycleGanEpoch",
                                        "pool_size": 4, "data": "train",
                                        "criterion": "default"},
                },
            },
            "output": {"learning": {"progress": {"print_each": 10}}},
            "data": {"train": {
                "dataset": {"name": "RandomDomainsPair",
                            "dataset_X": str(d / "day.txt"),
                            "dataset_Y": str(d / "night.txt"),
                            "image_dir": str(d / "ims") + "/*",
                            "size": 2},
                "loader": {"batch_size": 2, "num_workers": 1}}},
        },
        "2_output": {
            "__function__": "gandtr_tpu.stages.infer",
            "network": {
                "type": "SingleNetwork",
                "path": gan_dir + "/epochs/generator_X_best.ckpt",
                "model": dict(gen_model),
                "runtime": {"wrappers": "", "data": {}},
            },
            "data": {"image_dir": str(d / "ims") + "/*",
                     "transforms": "pil2np | totensor | normalize",
                     "mean_std": mean_std_gan,
                     "loader": {"batch_size": 2}},
            "output": {"type": "image",
                       "directory": os.path.join(out, "night_out"),
                       "structure": "flat"},
        },
        "3_finetune": {
            "__function__": "gandtr_tpu.stages.train",
            "network": {
                "type": "CirSequentialNetwork",
                "sequence": "augment,embed",
                "augment": {
                    "model": dict(gen_model),
                    "path": gan_dir + "/epochs/generator_X_best.ckpt",
                    "runtime": {
                        "frozen": True,
                        "wrappers": "meanstd_post:[[0.5,0.5,0.5],"
                                    "[0.5,0.5,0.5]]:[[0.485,0.456,0.406],"
                                    "[0.229,0.224,0.225]],"
                                    "cir_ratio_pass_through:0.5:anc",
                        "data": {"transforms": "pil2np | totensor | "
                                               "normalize",
                                 "mean_std": mean_std_gan}},
                },
                "embed": {"model": dict(cir),
                          "runtime": {"wrappers": "", "data": {}}},
            },
            "learning": {
                "checkpoints": {"directory": exp_ft},
                "training": {
                    "epochs": 1, "seed": 0,
                    "criterion": {"loss": "contrastive", "margin": 0.75},
                    "epoch_iteration": {"type": "SupervisedEpoch",
                                        "batch_average": False,
                                        "fakebatch": True, "data": "train",
                                        "criterion": "default"},
                    "optimizer": {"algorithm": "adam", "lr": FT_LR,
                                  "beta1": 0.9, "beta2": 0.999,
                                  "weight_decay": 0.0005},
                    "scheduler": {"algorithm": "gamma", "gamma": 0.99},
                },
            },
            "output": {"learning": {"progress": {"print_each": 10}}},
            "data": {"train": {
                "dataset": {"name": "CirDiverseAnchors",
                            "dataset_pkl": str(d / "train_db.pkl"),
                            "image_dir": str(d / "cids") + "/*",
                            "image_size": 32, "neg_num": 2, "pool_size": 10,
                            "query_size": 2, "qpool_size": 3,
                            "similar_exclude": 0.2, "similar_include": 0.8,
                            "split": "train"},
                "loader": {"batch_size": 2, "num_workers": 1}}},
        },
        "4_whitening": {
            "__function__":
                "gandtr_tpu.stages.multistep.infer_and_learn_whitening",
            "whitening": {"type": "lw",
                          "dataset_pkl": str(d / "whiten_db.pkl"),
                          "directory": ft_dir},
            "network": {"type": "SingleNetwork",
                        "path": ft_dir + "/epochs/embed_best.ckpt",
                        "model": dict(cir),
                        "runtime": {"wrappers": "", "data": {}}},
            "data": {"image_dir": str(d / "cids") + "/*",
                     "transforms": "pil2np | totensor | normalize",
                     "mean_std": imnet},
            "output": {"dimensions": 512},
        },
        "5_eval": {
            "__function__": "gandtr_tpu.stages.validate",
            "network": {
                "type": "SingleNetwork",
                "path": ft_dir + "/epochs/embed_best.ckpt",
                "model": dict(cir),
                "runtime": {"wrappers": {"eval": {
                    "0_cirwhiten": {
                        "whitening": "${4_whitening._output_metadata"
                                     ".whitening_path}",
                        "dimensions": None},
                    "1_cirmultiscale": {"scales": True}}}},
            },
            "data": {"image_size": 48,
                     "transforms": "pil2np | apply_clahe:1.0 | totensor | "
                                   "normalize",
                     "mean_std": imnet},
            "validation": {"dir_main": str(d / "test"),
                           "datasets": ["roxford5k"]},
        },
    }}


def with_initial_weights(scenario, root, gan_vars, embed_vars):
    """The port's scenario: each GAN net's and the embed's `pretrained:` a
    local file of the JAX initial variables."""
    scenario = copy.deepcopy(scenario)
    steps = scenario["all"]
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    nets = dict(from_jax_variables(host(gan_vars)))
    nets["embed"] = from_jax_variables(host(embed_vars))
    for name, sd in nets.items():
        path = os.path.join(root, "init_%s.pth" % name)
        torch.save(sd, path)
        if name == "embed":
            steps["3_finetune"]["network"]["embed"]["model"]["pretrained"] = \
                path
        else:
            steps["1_train_gan"]["network"][name]["model"]["pretrained"] = \
                path
    return scenario


def _recording(mp, module, name, wrap):
    orig = getattr(module, name)
    mp.setattr(module, name, wrap(orig))


@pytest.fixture(scope="module")
def chains(synth, tmp_path_factory):
    """Both runners on the scenario, recording the initial weights, the
    images the output step wrote, and the whitening's descriptors."""
    root = tmp_path_factory.mktemp("chains")
    rec = {"jax": {"images": {}, "vecs": []},
           "port": {"images": {}, "vecs": []}}
    init = {}

    def images_of(tag, module):
        def wrap(orig):
            def add(self, name, image, *args, **kwargs):
                conv = self._to_uint8 if tag == "jax" else self.to_uint8
                rec[tag]["images"][self.target_path(name)
                                   .rsplit("/", 1)[-1]] = conv(image)
                return orig(self, name, image, *args, **kwargs)
            return add
        return wrap

    def vecs_of(tag):
        def wrap(orig):
            def infer(*args, **kwargs):
                (meta,) = orig(*args, **kwargs)
                if "vecs" in meta:      # not the output step's
                    rec[tag]["vecs"].append(np.array(meta["vecs"]))
                return (meta,)
            return infer
        return wrap

    def capture(key, sub=None):
        def wrap(orig):
            def build(*args, **kwargs):
                exp = orig(*args, **kwargs)
                v = exp["variables"]
                init.setdefault(key, v[sub] if sub else v)
                return exp
            return build
        return wrap

    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        _recording(mp, jbuild, "build_gan_experiment", capture("gan"))
        _recording(mp, jfb, "build_finetune_experiment",
                   capture("embed", "embed"))
        _recording(mp, jinfer.RgbImageSaver, "add", images_of("jax", jinfer))
        # the JAX multistep stage imports infer when it runs
        _recording(mp, jinfer, "infer", vecs_of("jax"))
        jres = jrun.run_target(
            chain_scenario(synth, str(root / "jax")), "all", "allchain",
            stdin_data=list(NAMES))
    scenario = with_initial_weights(chain_scenario(synth, str(root / "port")),
                                    str(root), init["gan"], init["embed"])
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, tinfer.RgbImageSaver, "add",
                   images_of("port", tinfer))
        _recording(mp, tmultistep, "infer", vecs_of("port"))
        pres = run.run_target(copy.deepcopy(scenario), "all", "allchain",
                              stdin_data=list(NAMES), device="cpu")
    return {"jax": jres, "port": pres, "rec": rec, "root": root,
            "init_embed": init["embed"], "scenario": scenario}


def _events(directory):
    with open(os.path.join(directory, "epochs", "events.json")) as f:
        return json.load(f)


def test_every_step_ran_with_the_jax_metadata_keys(chains):
    jres, pres = chains["jax"], chains["port"]
    assert list(pres) == list(jres) == ["1_train_gan", "2_output",
                                        "3_finetune", "4_whitening",
                                        "5_eval"]
    for step in jres:
        assert sorted(pres[step]) == sorted(jres[step]), step
    for step in ("1_train_gan", "3_finetune"):
        p, j = pres[step], jres[step]
        assert sorted(p["metrics"]) == sorted(j["metrics"]), step
        assert sorted(p["metrics_series"]) == sorted(j["metrics_series"])
        assert p["best_epoch"] == j["best_epoch"]
        assert sorted(p["code_version"]) == ["git_dirty", "git_head",
                                             "numpy", "torch"]
        assert {"git_head", "numpy"} <= set(j["code_version"])
        assert {"wall_seconds", "cpu_seconds", "ram_gb"} == \
            set(p["resource_usage"])
        assert "cpu_seconds" in j["resource_usage"]
    assert sorted(pres["4_whitening"]["infer"]) == \
        sorted(jres["4_whitening"]["infer"])


def test_gan_step_against_jax(chains):
    """The GAN's events and stage metrics within 1e-3 of JAX's."""
    got = chains["port"]["1_train_gan"]
    want = chains["jax"]["1_train_gan"]
    (pe,), (je,) = _events(got["directory"]), _events(want["directory"])
    assert sorted(pe["metrics"]) == sorted(je["metrics"])
    for k, v in je["metrics"].items():
        np.testing.assert_allclose(pe["metrics"][k], v, rtol=1e-3, err_msg=k)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-3, err_msg=k)


def test_output_step_against_jax(chains):
    """The output step wrote the same file names, each image within one
    uint8 level of JAX's (compared before encoding: the names are .jpg)."""
    root = chains["root"]
    for tag in ("jax", "port"):
        assert sorted(os.listdir(root / tag / "night_out")) == NAMES
    got = chains["rec"]["port"]["images"]
    want = chains["rec"]["jax"]["images"]
    assert sorted(got) == sorted(want) == NAMES
    for k in NAMES:
        assert got[k].shape == want[k].shape == (40, 40, 3)
        assert np.abs(got[k].astype(int) - want[k]).max() <= 1, k


def test_finetune_step_against_jax(chains):
    """The fine-tune's losses within 1e-4 of JAX's, and embed_best.ckpt
    within tests/test_torch_finetune_loop_noclahe.py's elementwise bound:
    twice 1.05 lr a step. Adam's first step moves each weight by lr times
    its gradient's sign, so a sign that differs parts the two weights by
    2 lr. The loop test, on equal inputs, allows 1e-5 of the weights past
    1.05 lr; here the augment generators come from two GAN runs that
    differ by their own first-step flips (up to 1 GAN lr), so more of the
    embed's near-zero gradients change sign: 2.6e-3 of the weights on
    this set. The share is held under 1e-2."""
    got = chains["port"]["3_finetune"]
    want = chains["jax"]["3_finetune"]
    (pe,), (je,) = _events(got["directory"]), _events(want["directory"])
    for k, v in je["metrics"].items():
        if k.startswith("train/learning"):
            np.testing.assert_allclose(pe["metrics"][k], v, rtol=1e-4,
                                       err_msg=k)
    steps = len(want["metrics_series"]["train/learning/total"])
    jbest = load_network_file(
        os.path.join(want["directory"], "epochs", "embed_best.ckpt"),
        chains["init_embed"])
    jsd = from_jax_variables(jax.tree_util.tree_map(np.asarray, jbest))
    psd = torch.load(os.path.join(got["directory"], "epochs",
                                  "embed_best.ckpt"),
                     weights_only=True)["model_state"]
    assert sorted(psd) == sorted(jsd)
    flipped = total = 0
    for k, v in jsd.items():
        lim = 1.05 * FT_LR * steps * (10.0 if k == "pool.p" else 1.0)
        d = (psd[k] - v).abs()
        assert float(d.max()) <= 2 * lim, k
        flipped += int((d > lim).sum())
        total += d.numel()
    assert flipped <= 1e-2 * total, (flipped, total)


def test_whitening_step_against_jax(chains, tmp_path):
    """The whitening step's descriptors within 1e-4 of the JAX infer stage
    on the same net (the port's embed_best.ckpt, read by the JAX package
    as a reference .pth) and within 5e-3 of the JAX chain's, whose embed
    differs by the fine-tune's sign flips; the port's Lw equal to the JAX
    learning on the port's descriptors (1e-10)."""
    import pickle
    import shutil
    from gandtr_tpu.ops import whiten as jwhiten
    (pv,), (jv,) = chains["rec"]["port"]["vecs"], chains["rec"]["jax"]["vecs"]
    assert pv.shape == jv.shape == (512, 12)
    np.testing.assert_allclose(pv, jv, atol=5e-3, rtol=0)
    step = copy.deepcopy(chains["scenario"]["all"]["4_whitening"])
    pth = str(tmp_path / "embed_best.pth")
    shutil.copy(os.path.join(chains["port"]["3_finetune"]["directory"],
                             "epochs", "embed_best.ckpt"), pth)
    step["network"]["path"] = pth
    with open(step["whitening"]["dataset_pkl"], "rb") as f:
        db = pickle.load(f)
    paths = ["/".join([x[-2:], x[-4:-2], x[-6:-4], x]) for x in db["cids"]]
    (meta,) = jinfer.infer({"network": step["network"], "data": step["data"],
                            "output": {"type": "embedding",
                                       "dimensions": 512}}, (paths,))
    np.testing.assert_allclose(pv, meta["vecs"], atol=1e-4, rtol=0)
    with open(chains["port"]["4_whitening"]["whitening_path"], "rb") as f:
        lw = pickle.load(f)
    m, P = jwhiten.whitenlearn_with_retry(pv, db["qidxs"], db["pidxs"])
    np.testing.assert_allclose(lw["m"], m, atol=1e-10, rtol=0)
    np.testing.assert_allclose(lw["P"], P, atol=1e-10 * np.abs(P).max(),
                               rtol=0)


def test_eval_step_against_jax(chains):
    """The same metadata keys and the same mAPs."""
    got = chains["port"]["5_eval"]["metadata"]["validation"]
    want = chains["jax"]["5_eval"]["metadata"]["validation"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if "score_avg" in k:
            assert np.isfinite(got[k])
            np.testing.assert_allclose(got[k], v, atol=1e-12, err_msg=k)
