"""Build the GAN training experiment of a train scenario (counterpart of
gandtr_tpu/scenarios/build.py::build_gan_experiment; the reference's
initialize_learning) for the four families of the paper:

- HED^N-GAN, parameters/train_hedngan.yml: the NetworkSet generator_X,
  discriminator_Y, the student `detector` and its frozen teacher
  `detector_frozen` (HED; RCF in rcfngan.yml);
- HED-GAN, parameters/train_hedgan.yml: the same without the teacher and
  with a detector that does not train (HED; RCF in rcfgan.yml);
- CUT, parameters/train_cut.yml: generator_X, discriminator_Y and the
  `featdown` PatchSampleF, whose MLPs are made from the generator's taps
  on a sample input before the weights are set (the JAX package's lazy
  member), with the criterion's `nce` section (nce_layers, num_patches,
  temperature, weight, batch_dim_for_bmm) and a CPU torch.Generator for
  the patch positions, seeded from `learning.training.seed`;
- CycleGAN, parameters/train_cyclegan.yml: generator_X, generator_Y,
  discriminator_X, discriminator_Y, and two image pools of
  `epoch_iteration.pool_size`;

each with an Adam per trained network and its lr schedule, the step, the
loader of `data.train.dataset` (RandomDomainsPair as published, or
RandomImageTuple / PregeneratedImageTuple over a tuple list), events,
checkpoints and the visual validation.

    exp = build_gan_experiment(params, directory)        # on cuda
    state, start = exp["training"].resume_or_start(exp["state"])
    state = exp["training"].run(state, start_epoch=start)

Weights: a member with `initialize: {weights, seed, ...}` takes that
scheme with the rest of the dict as its parameters (`init_gain`, as the
JAX package passes them; models/init.py), any other seeded He-normal
weights from `learning.training.seed` and its position; then a local
`pretrained:` checkpoint loads strictly (a URL raises: the port
downloads nothing), and `detector_frozen` starts as a copy of
`detector`. The loader's shuffle state is saved with each training file,
so a resumed run repeats the straight run bit for bit.

`dispatch_chunk: K` is the loop's `chunk`: the same steps in the same
order, the metrics read back once a chunk.

The JAX package's opt-in knobs, each off by default under the same key:

- `epoch_iteration.concat_student` (HED^N-GAN): the E step's two student
  forwards as one (learning/gan_steps.py);
- `epoch_iteration.cache_teacher_targets: true | {max_items}` (HED^N-GAN):
  the teacher's targets cached across epochs (learning/teacher_cache.py);
  the step is then the cache, `dispatch_chunk` is off, and it cannot be
  combined with `device_scalecrop`;
- `data.train.device_scalecrop`: the loader ships uint8 crops and the
  resize and normalization run on the device; the chain must be `pil2np
  | scalecrop:... | totensor | normalize`, else the build raises (the JAX
  package warns and trains without the knob);
- `optimizer.composition: {alternate_iteration: n, order: a,b,...}`: the
  round robin of learning/optimizers.py::AlternationGate;
- a member `path:` (a warm start): its model config, runtime and weights
  from a local network file (`adopt_path_members`), loaded strictly in
  place of the seeded weights and of `pretrained:`.

A `MultiheadNetwork` member builds, takes its `initialize:` spec subnet
by subnet (base, split, heads, each drawn from the spec's seed, as the
JAX package's init_all does) and its optimizer by its `parameter_groups`;
but no GAN step runs one: the step raises (as the JAX steps cannot run
one: their `has_batch_stats` is a WrappedNet method the multi-head
container lacks). A `SingleNetworkLink` member is its target's network
and is not drawn again.

Data parallelism (parallel/mesh.py) is on by default under a process
group (`torchrun --nproc-per-node N`), as the JAX package's is over its
visible devices: `learning.training.parallel: false` turns it off,
`parallel: {devices: N}` takes min(N, world size) and raises below the
world size; a batch that does not divide warns and every rank runs the
whole step. The data-parallel step (and the teacher cache's two steps,
and the device scalecrop's) runs each rank's rows of the global batch
with the gradients all-reduced and BatchNorm over the global batch; the
weights and the optimizers' state are broadcast from rank 0, and rank 0
alone writes. `dispatch_chunk` is off under it, with the JAX package's
warning.
"""
import copy
import os
import warnings

import torch

from gandtr_tpu_torch.data.datasets import (InferImageListDataset, Loader,
                                            initialize_dataset_loader)
from gandtr_tpu_torch.data.transforms import (DeviceScalecrop,
                                              initialize_transforms,
                                              parse_device_scalecrop)
from gandtr_tpu_torch.device import resolve_device, upload
from gandtr_tpu_torch.hub import _checkpoint_net_state, _init_random
from gandtr_tpu_torch.learning import gan_steps
from gandtr_tpu_torch.learning.checkpoints import Checkpoints
from gandtr_tpu_torch.learning.criteria import check_criterion_losses
from gandtr_tpu_torch.learning.events import initialize_processor
from gandtr_tpu_torch.learning.image_pool import ImagePool
from gandtr_tpu_torch.learning.network import (MultiheadModule,
                                               build_network_set)
from gandtr_tpu_torch.learning.optimizers import (alternate,
                                                  initialize_optimizer)
from gandtr_tpu_torch.learning.schedules import initialize_schedule
from gandtr_tpu_torch.learning.teacher_cache import TeacherTargetCachingStep
from gandtr_tpu_torch.learning.training import (MultiCriterialValidation,
                                                Training, VisualValidation)
from gandtr_tpu_torch.models.init import initialize_weights
from gandtr_tpu_torch.ops.resize import dynamic_bilinear_resize_u8
from gandtr_tpu_torch.parallel import mesh
from gandtr_tpu_torch.utils.io import resolve_path
from gandtr_tpu_torch.utils.weights import load_pretrained

EPOCH_ITERATION_FAMILIES = {
    "SupervisedCycleGanEpoch": "cyclegan",
    "SupervisedCUTEpoch": "cut",
    "SupervisedCutEpoch": "cut",
    "SupervisedHEDGANEpoch": "hedgan",
    "SupervisedHedGanEpoch": "hedgan",
    "SupervisedHEDNGANEpoch": "hedngan",
    "SupervisedHedNGanEpoch": "hedngan",
}
GAN_MEAN_STD = [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]
VISUAL_IMAGES = 4   # the first images of the validation directory


def adopt_path_members(config):
    """Rewrite the path-form members of a NetworkSet config in place, as
    the reference's network.py:165-186 (the JAX package's
    `_adopt_path_members`): the member's `model` becomes its file's
    `network_params.model` (a `model` given too must equal it), its
    `runtime` the file's where it says `load_from_checkpoint` (the
    default), and its `initialize` is dropped. The file is a local
    reference `.pth` or one of the port's `Checkpoints` files; the path
    resolves under $GANDTR_ROOT, and a URL raises. Returns {name:
    model_state}."""
    states = {}
    for name, sub in list(config.items()):
        if not isinstance(sub, dict) or not sub.get("path"):
            continue
        path = resolve_path(str(sub["path"]))
        if "://" in path:
            raise NotImplementedError(
                "NetworkSet member %s path %r: only local files load (this "
                "package downloads nothing)" % (name, path))
        net = _checkpoint_net_state(torch.load(path, map_location="cpu",
                                               weights_only=False))
        saved = dict(net.get("network_params") or {})
        if not saved.get("model"):
            raise ValueError("NetworkSet member %s: %r holds no "
                             "network_params.model" % (name, path))
        sub = dict(sub)
        sub.pop("path")
        runtime = sub.get("runtime", "load_from_checkpoint")
        saved_rt = dict(saved.get("runtime") or {})
        if runtime == "load_from_checkpoint":
            runtime = copy.deepcopy(saved_rt)
        else:
            runtime = {k: (copy.deepcopy(saved_rt.get(k))
                           if v == "load_from_checkpoint" else v)
                       for k, v in dict(runtime).items()}
        if "model" in sub and sub["model"] != saved["model"]:
            raise ValueError("NetworkSet member %s: model %r differs from "
                             "its file's %r" % (name, sub["model"],
                                                saved["model"]))
        sub["model"] = copy.deepcopy(dict(saved["model"]))
        sub["runtime"] = runtime
        sub.pop("initialize", None)
        states[name] = {k: torch.as_tensor(v)
                        for k, v in net["model_state"].items()}
        config[name] = sub
    return states


def _init_nets(nets, init_specs, net_cfg, seed, device, path_states):
    """Seed, load and place every member; a path member takes its file's
    weights; the teacher copies the student; a multi-head member's
    `initialize:` spec draws each subnet in turn; a link shares its
    target's weights."""
    for i, (name, net) in enumerate(nets.items()):
        if any(net is nets[other] for other in list(nets)[:i]):
            continue      # a SingleNetworkLink: its target's network
        if name in path_states:
            # the file covers every parameter: its weights stand in for the
            # seeded ones and for any `pretrained:` of its model config
            net.module.load_state_dict(path_states[name], strict=True)
            continue
        spec = dict(init_specs.get(name) or {})
        if spec:
            # the whole dict reaches the scheme, as the JAX package passes
            # it: `init_gain` sets the p2p gain
            scheme, seed_ = spec.pop("weights", "normal_p2p"), \
                spec.pop("seed", 0)
            subnets = (net.module.nets.values()
                       if isinstance(net.module, MultiheadModule) else [net])
            for sub in subnets:
                initialize_weights(sub.module, scheme, seed_, **spec)
        else:
            _init_random(net.module, seed + i)
        load_pretrained(net.module,
                        (net_cfg[name].get("model") or {}).get("pretrained"),
                        "%s.model.pretrained" % name)
    if "detector_frozen" in nets and "detector" in nets:
        nets["detector_frozen"].module.load_state_dict(
            nets["detector"].module.state_dict())
    for net in nets.values():
        net.module.to(device)
        if net.frozen:
            net.module.eval().requires_grad_(False)


def _nce_options(crit):
    """build_cut_step's keyword arguments from the criterion's `nce`
    section."""
    nce = dict(crit.get("nce") or {})
    return {"nce_layers": tuple(int(i) for i in str(
                nce.get("nce_layers", "4,8,12,16")).split(",")),
            "num_patches": int(nce.get("num_patches", 256)),
            "temperature": float(nce.get("temperature", 0.07)),
            "nce_weight": float(nce.get("weight", 1.0)),
            "batch_dim_for_bmm": int(nce.get("batch_dim_for_bmm", 1))}


def _create_featdown(nets, nce_layers):
    """featdown's MLPs, one for each of the generator's taps on a sample
    input (in eval mode: no BatchNorm statistic moves)."""
    G = nets["generator_X"].module
    mode = G.training
    with torch.no_grad():
        feats = G.eval()(torch.zeros(1, 32, 32, G.meta["in_channels"]),
                         layers=nce_layers, encode_only=True)
    G.train(mode)
    nets["featdown"].module.create_mlp([f.shape[-1] for f in feats])


def _visual_validation(val_cfg):
    """The validations of a `MultiCriterialValidation` tree whose children
    are visual criteria (_gan_eval.yml); [] without a section. Only an
    empty or absent image directory skips a visual criterion."""
    if not isinstance(val_cfg, dict) or not val_cfg:
        return []
    children = {}
    for name, child in val_cfg.items():
        if name in ("type", "decisive_criterion", "__template__"):
            continue
        crit = dict((child or {}).get("criterion") or {})
        if crit.get("type") != "visual":
            raise NotImplementedError("validation %r of type %r is not "
                                      "ported yet" % (name, crit.get("type")))
        vdata = dict(crit.get("data") or {})
        image_dir = resolve_path((vdata.get("dataset") or {})
                                 .get("image_dir"))
        names = (sorted(os.listdir(image_dir))[:VISUAL_IMAGES]
                 if image_dir and os.path.isdir(image_dir) else [])
        if not names:
            warnings.warn("no validation images found in %r: the visual "
                          "validation %r is skipped" % (image_dir, name))
            continue
        mean_std = vdata.get("mean_std", GAN_MEAN_STD)
        dataset = InferImageListDataset(
            [names], initialize_transforms(
                vdata.get("transforms", "pil2np | totensor | normalize"),
                mean_std), image_dir)
        images = [imgs[0] for _, imgs in
                  Loader(dataset, batch_size=1, num_workers=0)]
        children[name] = VisualValidation(
            images, mean_std=mean_std,
            frequency=(child or {}).get("frequency", 1), names=names)
    if not children:
        return []
    return [MultiCriterialValidation(children,
                                     val_cfg.get("decisive_criterion"))]


def build_gan_experiment(params, directory=None, device=None):
    """params: the resolved train tree (network / learning / data /
    output). `directory` holds the checkpoints and events (none without
    it). Returns the JAX package's keys {"models", "variables",
    "optimizers", "state", "step", "training", "loader", "events",
    "checkpoints", "schedules", "base_lr", "family"}: `models` the
    WrappedNets by name, `variables` their state dicts, `step(state,
    real_X, real_Y)` on device tensors. Runs on cuda unless
    `device="cpu"`."""
    dev = resolve_device(device)
    params = copy.deepcopy(params)
    net_cfg = dict(params["network"])
    learn_cfg = params["learning"]
    train_cfg = dict(learn_cfg["training"])
    data_cfg = params.get("data") or {}
    config_snapshot = copy.deepcopy({"validation": learn_cfg.get("validation"),
                                     "datasets": data_cfg})
    it_cfg = dict(train_cfg.get("epoch_iteration") or {})
    family = EPOCH_ITERATION_FAMILIES[it_cfg.get("type",
                                                 "SupervisedHEDNGANEpoch")]
    opt_cfg = dict(train_cfg.get("optimizer") or {})
    crit = dict(train_cfg.get("criterion") or {})
    check_criterion_losses(crit, family)
    seed = int(train_cfg.get("seed", 0))

    net_cfg.pop("type", None)
    path_states = adopt_path_members(net_cfg)
    nets, init_specs = build_network_set({"type": "NetworkSet", **net_cfg})
    gen_data = nets["generator_X"].data_params or {}
    dsc = _device_scalecrop(data_cfg, gen_data, it_cfg)
    step_options, rngs = {}, {}
    if family == "cut":
        step_options = _nce_options(crit)
        _create_featdown(nets, step_options["nce_layers"])
        rngs = {"patches": torch.Generator().manual_seed(seed)}
    _init_nets(nets, init_specs, net_cfg, seed, dev, path_states)

    composition = opt_cfg.pop("composition", None)
    optimizers, base_lr = {}, {}
    for name, cfg in opt_cfg.items():
        if cfg is None:
            continue
        arch = ((net_cfg.get(name) or {}).get("model") or {}) \
            .get("architecture", "")
        optimizers[name], base_lr[name] = initialize_optimizer(
            dict(cfg), nets[name].module.named_parameters(), arch,
            getattr(nets[name].module, "parameter_groups", None))
    optimizers = alternate(optimizers, composition)
    epochs = int(train_cfg.get("epochs", 1))
    sched_cfg = dict(train_cfg.get("scheduler") or {})
    sched_cfg.pop("composition", None)
    schedules = {name: initialize_schedule(epochs, dict(cfg))
                 for name, cfg in sched_cfg.items() if cfg is not None}

    pools, weights = {}, [crit.get("weights")]
    if family == "cyclegan":
        pool_size = int(it_cfg.get("pool_size", 50))
        pools = {"fake_X_pool": ImagePool(pool_size, seed),
                 "fake_Y_pool": ImagePool(pool_size, seed + 1)}
        # each generator's loss has its own weights
        weights = [(crit.get(k) or {}).get("weights")
                   for k in ("loss_G_X", "loss_G_Y")]
    cache_cfg = it_cfg.get("cache_teacher_targets") \
        if family == "hedngan" else None
    if family == "hedngan":
        step_options = {"concat_student":
                        bool(it_cfg.get("concat_student", False)),
                        "emit_targets": bool(cache_cfg)}
    weights = [dict(w or {}) for w in weights]
    multihead = [name for name, net in nets.items()
                 if isinstance(net.module, MultiheadModule)]
    batch_to_args = lambda b: (upload(b[0], dev), upload(b[1], dev))  # noqa
    if multihead:
        # no knob wraps a step that refuses
        step, cache_cfg, dsc = \
            gan_steps.refused_multihead_step(multihead), None, None
    else:
        step = gan_steps.GAN_STEPS[family](nets, optimizers, *weights,
                                           **step_options)
    # data parallelism over the process group, if there is one (the JAX
    # package's _maybe_data_parallel); the batch the loader will use
    par_cfg = train_cfg.get("parallel", True)
    batch_size = int(((data_cfg.get("train") or {}).get("loader") or {})
                     .get("batch_size", 0) or 0)

    def parallel(s):
        return mesh.maybe_data_parallel(s, par_cfg, batch_size)

    if cache_cfg:
        step = TeacherTargetCachingStep(
            parallel(step), parallel(gan_steps.build_hedngan_step(
                nets, optimizers, *weights,
                concat_student=step_options["concat_student"],
                external_targets=True)),
            dev, max_items=(cache_cfg.get("max_items", 64)
                            if isinstance(cache_cfg, dict) else 64))
        batch_to_args = step.batch_to_args
    elif dsc is not None:
        step = parallel(_device_scalecrop_step(step, dsc))
        batch_to_args = lambda b: tuple(upload(a, dev) for a in b)  # noqa
    else:
        step = parallel(step)
    data_parallel = getattr(
        getattr(step, "internal_step", step), "gandtr_dp", False)
    if data_parallel:
        mesh.attach_optimizers(optimizers.values())
    # one set of weights and optimizer state on every rank
    mesh.replicate_tree(nets, optimizers)
    state = gan_steps.make_gan_state(nets, optimizers, pools, rngs)

    loader = None
    if data_cfg.get("train"):
        dp = copy.deepcopy(data_cfg["train"])
        dp.setdefault("transforms", gen_data.get("transforms"))
        dp.setdefault("mean_std", gen_data.get("mean_std"))
        dp.pop("device_scalecrop", None)
        loader = initialize_dataset_loader([], dp, {"shuffle": True})
        if dsc is not None:
            # the host half of the chain; the device half is in `step`
            loader.dataset.transform = DeviceScalecrop(dsc["sc"])

    out_cfg = (params.get("output") or {}).get("learning", {})
    val_cfg = learn_cfg.get("validation") or {}
    events = initialize_processor(
        out_cfg, directory=directory,
        decisive_criterion=val_cfg.get("decisive_criterion")
        if isinstance(val_cfg, dict) else None)
    ckpt_cfg = dict(learn_cfg.get("checkpoints") or {})
    checkpoints = Checkpoints(
        directory,
        store_every=ckpt_cfg.get("store_every", 10) or 0,
        checkpoint_every=ckpt_cfg.get("checkpoint_every", 2) or 0,
        directory_epoch_regex=ckpt_cfg.get("directory_epoch_regex")) \
        if directory else None
    frozen = tuple(name for name, net in nets.items() if net.frozen)
    validations = _visual_validation(val_cfg)

    # the cache decides on the host, batch by batch, which step runs
    chunk = 0 if cache_cfg else int(train_cfg.get("dispatch_chunk", 0) or 0)
    if chunk > 1 and data_parallel:
        warnings.warn("dispatch_chunk disabled: data-parallel step active")
        chunk = 0
    training = None
    if loader is not None:
        if chunk > 1:
            loader.prefetch = max(loader.prefetch, chunk + 2)
        training = Training(
            step_fn=step, loader=loader, epochs=epochs, seed=seed,
            optimizers_base_lr=base_lr, schedules=schedules, events=events,
            checkpoints=checkpoints, frozen=frozen, validations=validations,
            batch_to_args=batch_to_args, mean_std=(data_cfg.get("train") or {}).get(
                "mean_std", gen_data.get("mean_std")),
            config_snapshot=config_snapshot, chunk=chunk,
            net_params={name: {"model": (net_cfg[name] or {}).get("model"),
                               "runtime": (net_cfg[name] or {})
                               .get("runtime")}
                        for name in nets},
            rng_states={"loader": loader.rng},
            profile_dir=out_cfg.get("profile"))

    return {"models": nets,
            "variables": {k: n.module.state_dict() for k, n in nets.items()},
            "optimizers": optimizers, "state": state, "step": step,
            "training": training, "loader": loader, "events": events,
            "checkpoints": checkpoints, "schedules": schedules,
            "base_lr": base_lr, "family": family}


def _device_scalecrop(data_cfg, gen_data, it_cfg):
    """The pieces of `data.train.device_scalecrop` (None when it is off):
    the train chain must be `pil2np | scalecrop:... | totensor |
    normalize`, and the teacher cache must be off."""
    train = data_cfg.get("train") or {}
    if not train.get("device_scalecrop"):
        return None
    tstr = train.get("transforms", gen_data.get("transforms"))
    dsc = parse_device_scalecrop(tstr, train.get(
        "mean_std", gen_data.get("mean_std", GAN_MEAN_STD)))
    if dsc is None:
        raise ValueError("data.train.device_scalecrop needs the chain "
                         "'pil2np | scalecrop:... | totensor | normalize', "
                         "got %r" % tstr)
    if it_cfg.get("cache_teacher_targets"):
        raise NotImplementedError(
            "device_scalecrop is incompatible with cache_teacher_targets "
            "(the cache keys and uploads two float batches)")
    return dsc


def _device_scalecrop_step(inner, dsc):
    """step(state, x_u8, x_hw, y_u8, y_hw): the device half of the
    scalecrop chain (/255, the resize, the normalization), then `inner`."""
    oh, ow = dsc["out_hw"]

    def stage(imgs_u8, hws):
        mean = dsc["mean"].to(imgs_u8.device)
        std = dsc["std"].to(imgs_u8.device)
        return (dynamic_bilinear_resize_u8(imgs_u8, hws, oh, ow) - mean) / std

    def step(state, x_u8, x_hw, y_u8, y_hw):
        return inner(state, stage(x_u8, x_hw), stage(y_u8, y_hw))

    step.stage = stage
    return step
