"""Shared set-up of the tests that hold the port's HED^N-GAN training
(gandtr_tpu_torch) against the JAX package's: the shipped
parameters/train_hedngan.yml cut to micro size, a seeded domain-pair image
set, and the JAX nets' variables filled from a seeded numpy draw over
their shapes (`jax.eval_shape`), since a real JAX init compiles op by op
for a minute on the CPU."""
import copy
import os

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_HEDNGAN = os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs",
                             "iccv23", "parameters", "train_hedngan.yml")
SIDE = 32          # the micro crop, scalecrop:32_32:0.8_1
SHAPES = [(36, 48), (48, 36), (40, 40)]


def seeded_variables(shapes, seed):
    """Values for a JAX variables tree of ShapeDtypeStructs: He-normal conv
    kernels, zero biases, BatchNorm scales around 1 and fresh running
    statistics."""
    import jax
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        if getattr(path[0], "key", "") == "batch_stats":
            return (np.zeros if name == "mean" else np.ones)(leaf.shape,
                                                             np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rs.randn(*leaf.shape) * np.sqrt(2.0 / fan_in)) \
                .astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rs.randn(*leaf.shape)).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def shape_init(monkeypatch):
    """The JAX ModelSet.init_all by shape: each net's variables from
    `seeded_variables` (seed 10 + its position)."""
    import jax
    import jax.numpy as jnp
    from gandtr_tpu.learning import network as jn

    def init_all(self, rng, sample_inputs, init_specs=None, lazy=()):
        out = {}
        for i, (name, net) in enumerate(self.nets.items()):
            if name not in sample_inputs:   # a lazy member (CUT's featdown)
                continue
            shapes = jax.eval_shape(
                lambda x, net=net: net.init(jax.random.PRNGKey(0), x),
                sample_inputs[name])
            out[name] = jax.tree_util.tree_map(
                jnp.asarray, seeded_variables(dict(shapes), 10 + i))
        return out
    monkeypatch.setattr(jn.ModelSet, "init_all", init_all)


def micro_config(root, n=6, size=8, batch=2, epochs=2, path=TRAIN_HEDNGAN):
    """train_hedngan.yml (or the parameters file at `path`, through the JAX
    scenario engine, its validation template included) at micro size: ngf
    4 with one block, ndf 4, HED at width 0.0625 (RCF at full width)
    without the published file, 2 epochs with the decay in
    the second, checkpoint_every 1 and store_every 2, visual validation
    every epoch on 4 images, `size` pairs of 32x32 crops from n seeded
    JPEGs a domain, the loader single-threaded (the JAX package's draws
    are sequential only there)."""
    from gandtr_tpu.scenarios.engine import load_yaml_scenario
    cfg = load_yaml_scenario([path])
    return micro_section(cfg, root, n, size, batch, epochs)


def micro_section(cfg, root, n=6, size=8, batch=2, epochs=2):
    """A GAN train section (network / learning / data / output) cut to
    micro_config's size, in place."""
    net = cfg["network"]
    net["generator_X"]["model"].update(ngf=4, n_blocks=1)
    net["discriminator_Y"]["model"].update(ndf=4)
    for k in ("detector", "detector_frozen"):
        if net.get(k):
            net[k]["model"].update(width_mult=0.0625, pretrained=None)
    lt = cfg["learning"]["training"]
    lt.update(epochs=epochs, parallel=False)
    for sched in lt["scheduler"].values():
        if sched:
            sched["n_epochs_decay"] = 1
    cfg["learning"]["checkpoints"].update(
        directory=os.path.join(root, "exp"), checkpoint_every=1,
        store_every=2)
    vis = cfg["learning"]["validation"]["visual"]
    vis["frequency"] = 1
    vdata = vis["criterion"]["data"]
    vdata["dataset"]["image_dir"] = os.path.join(root, "val")
    vdata["transforms"] = "pil2np | downscale:40 | totensor | normalize"
    lists = write_domain_set(root, n)
    cfg["data"]["train"]["dataset"].update(
        dataset_X=lists[0], dataset_Y=lists[1],
        image_dir=os.path.join(root, "ims") + "/*", size=size)
    cfg["data"]["train"]["loader"] = {"batch_size": batch, "num_workers": 0}
    cfg["data"]["train"]["transforms"] = \
        "pil2np | scalecrop:%d_%d:0.8_1 | totensor | normalize" % (SIDE, SIDE)
    cfg["output"]["learning"]["progress"]["print_each"] = 0
    return cfg


def write_domain_set(root, n=6, seed=5):
    """n seeded JPEGs a domain under <root>/ims, their list files, and 4
    validation JPEGs under <root>/val. Returns the two list paths."""
    ims, val = os.path.join(root, "ims"), os.path.join(root, "val")
    os.makedirs(ims, exist_ok=True)
    os.makedirs(val, exist_ok=True)
    rs = np.random.RandomState(seed)
    lists = []
    for d in ("day", "night"):
        names = []
        for i in range(n):
            h, w = SHAPES[i % len(SHAPES)]
            Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)) \
                .save(os.path.join(ims, "%s%d.jpg" % (d, i)), quality=90)
            names.append("%s%d.jpg" % (d, i))
        lists.append(os.path.join(root, d + ".txt"))
        with open(lists[-1], "w") as f:
            f.write("\n".join(names) + "\n")
    for i in range(4):
        Image.fromarray(rs.randint(0, 256, (60, 80, 3), dtype=np.uint8)) \
            .save(os.path.join(val, "v%d.jpg" % i))
    return lists


def without_data(cfg):
    return {k: copy.deepcopy(v) for k, v in cfg.items() if k != "data"}


def train_target_pair(yml, root, tune=None, patch=None):
    """`yml`'s `train` target through the JAX package's run_target, then
    through the port's on the CPU: its train section cut by micro_section
    and then `tune(section)`, each package writing under <root>/<jax|port>.
    The download step is stubbed in both (it checks, or in the JAX
    package fetches, SfM-120k, which the test does not have). The JAX nets
    start from shape_init's values; the port's from the same ones, as
    local `pretrained:` files. `patch(mp)` runs in both packages'
    monkeypatch contexts. Returns {"jax", "port"} (each run_target's
    results), "jexp" (the JAX experiment the stage built) and "section"
    (the port's train section)."""
    import gandtr_tpu.scenarios.build as jbuild
    from gandtr_tpu.scenarios import run as jrun
    from gandtr_tpu.scenarios.engine import load_yaml_scenario
    from gandtr_tpu_torch.scenarios import run as prun
    import pytest
    scenario = load_yaml_scenario([yml])
    scenario = {"train": scenario["train"]}
    section = micro_section(scenario["train"]["1_train_augment"], root)
    if tune:
        tune(section)
    download = "gandtr_tpu.utils.download.rsfm120k"
    captured = {}
    jscen = copy.deepcopy(scenario)
    jscen["train"]["1_train_augment"]["learning"]["checkpoints"][
        "directory"] = os.path.join(root, "jax")
    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        orig = jbuild.build_gan_experiment

        def recording(*args, **kwargs):
            exp = orig(*args, **kwargs)
            captured.setdefault("exp", exp)
            return exp
        mp.setattr(jbuild, "build_gan_experiment", recording)
        mp.setitem(jrun.FUNCTIONS, download, lambda params, data: ({},))
        if patch:
            patch(mp)
        jres = jrun.run_target(jscen, "train", "micro")
    from test_torch_gan_train import _with_initial_weights
    psec = _with_initial_weights(section, root, captured["exp"]["variables"])
    psec["learning"]["checkpoints"]["directory"] = os.path.join(root,
                                                                "port")
    pscen = {"train": dict(scenario["train"], **{"1_train_augment": psec})}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(prun.FUNCTIONS, download,
                   lambda params, data, device: ({},))
        if patch:
            patch(mp)
        pres = prun.run_target(copy.deepcopy(pscen), "train", "micro",
                               device="cpu")
    return {"jax": jres, "port": pres, "jexp": captured["exp"],
            "section": psec, "jdir": os.path.join(root, "jax"),
            "pdir": os.path.join(root, "port")}


def adam_reach(steps, beta1, beta2=0.999):
    """The most that `steps` Adam steps of lr 1 can move a parameter: step
    t moves it by at most sqrt(sum_i w_i**2 / v_i) (Cauchy-Schwarz over
    the bias-corrected moments' weights w_i and v_i), 1 at the first
    step, 1.054 at the second for beta1 0.5."""
    total = 0.0
    for t in range(1, steps + 1):
        w = [(1 - beta1) * beta1 ** (t - i) / (1 - beta1 ** t)
             for i in range(1, t + 1)]
        v = [(1 - beta2) * beta2 ** (t - i) / (1 - beta2 ** t)
             for i in range(1, t + 1)]
        total += sum(a * a / b for a, b in zip(w, v)) ** 0.5
    return total
