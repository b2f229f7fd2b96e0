"""The port's HED^N-GAN step against the JAX package's
`build_hedngan_step`, on the CPU at micro size (train_hedngan.yml's
networks, optimizers and criterion; ngf 4 with one block, ndf 4, HED at
width 0.0625, batches of two 32x32 images): one and three steps on shared
weights and seeded batches, the step-1 tie of the student and its
teacher, the order of the updates, and what the build refuses."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.scenarios.build import build_gan_experiment as j_build
from gandtr_tpu_torch.ops import losses as PL
from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.utils.weights import from_jax_variables
from torch_gan_common import micro_config, shape_init, without_data

torch.set_num_threads(1)

STEPS = 3
METRICS = ("total", "D_real", "D_fake", "G_gan", "G_hed", "E_real",
           "E_fake")


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [tuple(rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
                  for _ in range(2)) for _ in range(n)]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_experiment(cfg, variables):
    exp = build_gan_experiment(without_data(cfg), device="cpu")
    for name, sd in from_jax_variables(_host(variables)).items():
        exp["models"][name].module.load_state_dict(sd, strict=True)
    return exp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX and port, STEPS steps each from the same weights on the same
    batches: metrics and variables after every step."""
    cfg = micro_config(str(tmp_path_factory.mktemp("gan_step")))
    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        jexp = j_build(without_data(cfg), sample_hw=32)
    exp = _port_experiment(cfg, jexp["variables"])
    jstate, state = jexp["state"], exp["state"]
    out = {"jax": [], "port": [], "cfg": cfg,
           "init": from_jax_variables(_host(jexp["variables"])),
           "lr": {name: [g["lr"] for g in opt.param_groups]
                  for name, opt in exp["optimizers"].items()},
           "groups": {name: [[id(p) for p in g["params"]]
                             for g in opt.param_groups]
                      for name, opt in exp["optimizers"].items()},
           "exp": exp}
    for X, Y in _batches(STEPS):
        jstate, jm, _ = jexp["step"](jstate, jnp.asarray(X), jnp.asarray(Y))
        out["jax"].append((_host(jm), from_jax_variables(
            _host(jstate.variables))))
        state, m, dbg = exp["step"](state, torch.from_numpy(X),
                                    torch.from_numpy(Y))
        out["port"].append(({k: float(v) for k, v in m.items()},
                            {name: {k: v.clone() for k, v in
                                    net.module.state_dict().items()}
                             for name, net in exp["models"].items()}, dbg))
    return out


def _lr_bound(runs, name, key, n):
    """2 lr per Adam step, with the parameter's group multiplier."""
    module = runs["exp"]["models"][name].module
    params = dict(module.named_parameters())
    pid = id(params[key])
    for lr, ids in zip(runs["lr"][name], runs["groups"][name]):
        if pid in ids:
            return 2 * lr * n
    raise KeyError(key)


@pytest.mark.parametrize("n", [1, STEPS])
def test_steps_against_jax(runs, n):
    """After n steps: each metric within rtol 2e-3 / atol 2e-4 of JAX's
    (tests/test_gan_step_golden.py's bound), every trained parameter
    within 2 lr per Adam step, every BatchNorm statistic within 1e-5, the
    teacher unchanged."""
    (jm, jv), (pm, pv, _) = runs["jax"][n - 1], runs["port"][n - 1]
    for k in METRICS:
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=2e-3, atol=2e-4,
                                   err_msg=k)
    for name in ("generator_X", "discriminator_Y", "detector"):
        for key, want in jv[name].items():
            got = pv[name][key]
            if key.endswith("num_batches_tracked"):
                continue
            diff = float((got.double() - want.double()).abs().max())
            if key.endswith(("running_mean", "running_var")):
                assert diff <= 1e-5, (name, key, diff)
            else:
                assert diff <= _lr_bound(runs, name, key, n), \
                    (name, key, diff)
    for key, want in runs["init"]["detector_frozen"].items():
        assert torch.equal(pv["detector_frozen"][key], want), key


def test_metrics_track_jax_closely(runs):
    """Beyond the golden bound: the port's metrics are JAX's within float
    rounding at every step (the same ops in the same order)."""
    for (jm, _), (pm, _, _) in zip(runs["jax"], runs["port"]):
        for k in METRICS:
            np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_step_one_tie_is_exact(runs):
    """At step 1 the student is its teacher: E_real is exactly 0 in both
    packages, and the student's real-branch L1 takes exactly no gradient
    (torch's tie subgradient)."""
    assert runs["port"][0][0]["E_real"] == 0.0
    assert float(runs["jax"][0][0]["E_real"]) == 0.0
    cfg = runs["cfg"]
    exp = build_gan_experiment(without_data(cfg), device="cpu")
    H_s, H_t = exp["models"]["detector"], exp["models"]["detector_frozen"]
    X = torch.from_numpy(_batches(1, seed=3)[0][0])
    with torch.no_grad():
        target = H_t.apply(X, no_sigmoid=True)
    real_M = H_s.apply(X, no_sigmoid=True)
    assert torch.equal(real_M.detach(), target)
    PL.l1_loss(real_M, target).backward()
    grads = [p.grad for p in H_s.module.parameters()]
    assert all(g is not None and float(g.abs().max()) == 0.0 for g in grads)


def test_step_order_and_statistics():
    """Each step moves D's statistics three times (real, fake, the G
    step's forward) and G's once; D and the student take no gradient in
    the G step and their parameters train again after it; the debug dict
    holds the last sample's images and edge maps."""
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        cfg = micro_config(root)
    exp = build_gan_experiment(without_data(cfg), device="cpu")
    D, Hs = exp["models"]["discriminator_Y"], exp["models"]["detector"]
    seen = {}
    for name in ("discriminator_Y", "detector"):
        opt = exp["optimizers"][name]
        orig = opt.step

        def step(*a, name=name, orig=orig, **k):
            net = exp["models"][name].module
            seen[name] = [p.grad.clone() for p in net.parameters()]
            return orig(*a, **k)
        opt.step = step
    X, Y = (torch.from_numpy(a) for a in _batches(1)[0])
    state, metrics, debug = exp["step"](exp["state"], X, Y)
    bn = [m for m in D.module.modules() if hasattr(m, "num_batches_tracked")]
    assert bn and all(int(m.num_batches_tracked) == 3 for m in bn)
    gbn = [m for m in exp["models"]["generator_X"].module.modules()
           if hasattr(m, "num_batches_tracked")]
    assert gbn and all(int(m.num_batches_tracked) == 1 for m in gbn)
    for name, net in (("discriminator_Y", D), ("detector", Hs)):
        for p, g in zip(net.module.parameters(), seen[name]):
            assert p.requires_grad and torch.equal(p.grad, g)
    assert state.step == 1 and sorted(metrics) == sorted(METRICS)
    assert debug["real_X"].shape == debug["fake_Y"].shape == (32, 32, 3)
    assert debug["real_E"].shape == debug["real_E_check"].shape \
        == (32, 32, 1)
    assert torch.equal(debug["real_X"], X[-1])


def _cfg_with(tmp_path, path, value):
    cfg = micro_config(str(tmp_path))
    node = cfg
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value
    return cfg


@pytest.mark.parametrize("path,value,match", [
    (("learning", "training", "parallel"), {"devices": 2},
     "data-parallel GAN training.*ROADMAP A.6"),
    (("learning", "training", "parallel"), {"devices": 4},
     "data-parallel GAN training.*ROADMAP A.6"),
    (("network", "generator_X", "model", "no_antialias"), False,
     "blur-pool.*not ported"),
    (("network", "generator_X", "model", "no_antialias_up"), False,
     "blur-pool.*not ported"),
    (("network", "discriminator_Y", "model", "no_antialias"), False,
     "blur-pool.*not ported"),
    (("network", "generator_X", "model", "architecture"),
     "official_p2p_unet_generator", "architecture.*not ported"),
    (("network", "generator_X", "type"), "MultiheadNetwork",
     "MultiheadNetwork is not ported"),
    (("network", "generator_X", "type"), "SingleNetworkLink",
     "SingleNetworkLink is not ported"),
    (("learning", "training", "optimizer", "detector", "algorithm"),
     "rmsprop", "optimizer 'rmsprop' is not ported"),
    (("data", "train", "dataset", "name"), "PregeneratedImageTuple",
     "dataset 'PregeneratedImageTuple' is not ported"),
    (("learning", "training", "criterion", "adversarial", "criterion",
      "loss"), "bce", "'bce' is not implemented by the hedngan step"),
])
def test_build_refuses_what_is_not_ported(tmp_path, path, value, match):
    """The blur-pool and U-Net members, once refused, are ported: the
    blur-pool cases now build, with the blur steps the config names; the
    U-Net takes none of the ResNet generator's keys (`no_antialias`, ...)
    and raises TypeError on them, as the JAX package's does. The
    MultiheadNetwork and SingleNetworkLink members are ported too
    (tests/test_torch_containers.py; the ids keep their old match text):
    a SingleNetwork's keys name no `network_order` and no link target, so
    both packages raise KeyError."""
    cfg = _cfg_with(tmp_path, path, value)
    if value in ("MultiheadNetwork", "SingleNetworkLink"):
        from gandtr_tpu.learning.network import build_model_set
        with pytest.raises(KeyError):
            build_model_set(copy.deepcopy(cfg["network"]))
        with pytest.raises(KeyError, match="network_order|no member"):
            build_gan_experiment(cfg, device="cpu")
        return
    if "blur-pool" in match:
        exp = build_gan_experiment(cfg, device="cpu")
        module = exp["models"][path[1]].module
        kinds = {type(m).__name__ for m in module.modules()}
        assert ("BlurUpsample" if path[-1] == "no_antialias_up"
                else "BlurDownsample") in kinds
        return
    if value == "official_p2p_unet_generator":
        with pytest.raises(TypeError, match="no_antialias"):
            build_gan_experiment(cfg, device="cpu")
        return
    if value == "PregeneratedImageTuple":
        # ported: the loader takes the tuples the JAX dataset draws
        from gandtr_tpu.data.datasets import PregeneratedImageTupleDataset
        ds = cfg["data"]["train"]["dataset"]
        names = [["%s%d.jpg" % (d, i) for d in ("day", "night")]
                 for i in range(6)]
        cfg["data"]["train"]["dataset"] = {
            "name": value, "dataset": {"train": names}, "data_key": "train",
            "image_dir": ds["image_dir"], "idx": "0_1"}
        loader = build_gan_experiment(cfg, device="cpu")["loader"]
        want = PregeneratedImageTupleDataset(
            [], None, {"train": names}, "train", ds["image_dir"], "0_1")
        assert type(loader.dataset).__name__ == value + "Dataset"
        assert loader.dataset.epoch_images == want.epoch_images
        X, Y = next(iter(loader))
        assert X.shape == Y.shape and X.shape[-1] == 3
        return
    with pytest.raises(NotImplementedError, match=match):
        build_gan_experiment(cfg, device="cpu")


def test_build_refuses_a_pretrained_url(tmp_path):
    """train_hedngan.yml as shipped names the published HED by URL: the
    port raises where the JAX package warns and keeps random weights."""
    cfg = micro_config(str(tmp_path))
    url = ("http://ptak.felk.cvut.cz/personal/jenicto2/download/iccv23_gan/"
           "hed_sniklaus_github.pth")
    cfg["network"]["detector"]["model"]["pretrained"] = url
    with pytest.raises(NotImplementedError, match="downloads nothing"):
        build_gan_experiment(copy.deepcopy(cfg), device="cpu")
