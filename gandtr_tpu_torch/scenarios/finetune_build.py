"""Build the GeM fine-tune experiment of parameters/finetune.yml (counterpart
of gandtr_tpu/scenarios/finetune_build.py): augment (a frozen generator with
the meanstd / CLAHE / ratio-gate wrappers) -> embed (GeM-VGG16), mined
tuples, contrastive loss, Adam, epochs with events and checkpoints.

Tuples arrive as uint8 images padded into a square bucket with each image's
valid (h, w), as the JAX package stages them: the step rebuilds the masks
on the device, applies /255 and the generator's normalization there, and
re-zeroes the pad band. Each epoch mines new tuples through the same
augment + embed chain (`_make_extract_fn`) with the current weights.

    exp = build_finetune_experiment(params, directory, db, images)  # cuda
    state = exp["training"].run(exp["state"])
    # or continue an interrupted experiment:
    state, start = exp["training"].resume_or_start(exp["state"])
    state = exp["training"].run(state, start_epoch=start)

Without a tuple database (`db` or `data.train.dataset.dataset_pkl`) the
experiment has no loader and no training; its `step` still takes batches:

    state, metrics = exp["step"](exp["state"], imgs_u8, hws, labels, pmask)

imgs_u8 (T, S, H, W, 3) uint8, hws (T, S, 2) int32, labels (T, S) float,
pmask (T, S) bool, all on the experiment's device.

A `learning.validation` section with a `data.val` split adds the
validation loss (`LossValidation`, every `frequency` epochs, 5 by
default): val tuples mined with the current weights through the train
chain's augment + embed (`shuffle` off), staged as uint8 like the train
tuples, and scored, as the JAX package scores them, by the embed on the
generator-normalized images (the augment chain left out) with the
contrastive loss at the criterion's margin. `val/learning/loss:total` is
then the decisive criterion: `_best` follows the lowest validation loss.
A pickle without the val split warns and validates on the train db (the
JAX package's fallback); any other failure of the validation's set-up
raises, where the JAX package warns and trains without it.
"""
import copy
import os
import re
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gandtr_tpu_torch.data.cir_datasets import (TupleEpochDataset,
                                                generator_safe_bucket,
                                                load_tuples_db,
                                                load_u8_padded)
from gandtr_tpu_torch.data.datasets import Loader
from gandtr_tpu_torch.data.mining import TuplesMiner
from gandtr_tpu_torch.data.transforms import split_device_transform
from gandtr_tpu_torch.device import resolve_device, upload
from gandtr_tpu_torch.hub import _checkpoint_model_state, _init_random
from gandtr_tpu_torch.learning import supervised
from gandtr_tpu_torch.learning.checkpoints import Checkpoints
from gandtr_tpu_torch.learning.criteria import initialize_criterion
from gandtr_tpu_torch.learning.events import initialize_processor
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.learning.optimizers import initialize_optimizer
from gandtr_tpu_torch.learning.schedules import initialize_schedule
from gandtr_tpu_torch.learning.training import LossValidation, Training
from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                metadata_name)
from gandtr_tpu_torch.models.init import initialize_weights
from gandtr_tpu_torch.ops import losses as L
from gandtr_tpu_torch.parallel import mesh
from gandtr_tpu_torch.utils.io import resolve_path
from gandtr_tpu_torch.utils.weights import load_pretrained

GENERATOR_DATA = {"transforms": "pil2np | totensor | normalize",
                  "mean_std": [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]}
EXTRACT_BATCH = 32   # images a mining extraction batch


def _load_local(module, path, what):
    """Load a local reference checkpoint into `module` (a relative path
    under $GANDTR_ROOT); warn and keep the seeded weights when the file is
    not there (as the JAX package does)."""
    if not path:
        return
    path = resolve_path(str(path))
    if "://" in str(path) or not os.path.exists(str(path)):
        warnings.warn("%s checkpoint %r not loaded: not a local file; the "
                      "weights stay seeded" % (what, path))
        return
    state = torch.load(str(path), map_location="cpu", weights_only=False)
    module.load_state_dict(_checkpoint_model_state(state), strict=True)


def _parse_ratio(wrappers_str):
    """(ratio, label) from `...cir_ratio_pass_through:0.25:anc`."""
    if isinstance(wrappers_str, str) and \
            "cir_ratio_pass_through" in wrappers_str:
        part = wrappers_str.split("cir_ratio_pass_through:", 1)[1]
        bits = part.split(",")[0].split(":")
        return float(bits[0]), bits[1] if len(bits) > 1 else "anc"
    return 0.0, "anc"


def _augment_positions(augment_cfg, ds_cfg):
    """The tuple positions the ratio gate's label can select, when that is
    a proper subset of the layout [anc, pos, neg...] (finetune_build.py:
    168-187); else None (the generator runs on every position)."""
    _, label = _parse_ratio((augment_cfg.get("runtime") or {})
                            .get("wrappers", ""))
    neg_num = int(ds_cfg.get("neg_num", 5))
    first_neg = ds_cfg.get("first_neg", "neg")
    if first_neg == "exc":
        layout = ["anc", "pos"] + ["neg"] * max(neg_num - 1, 0)
    else:
        layout = ["anc", "pos"] + ([first_neg] + ["neg"] * (neg_num - 1)
                                   if neg_num else [])
    positions = tuple(i for i, l in enumerate(layout) if re.match(label, l))
    return positions if 0 < len(positions) < len(layout) else None


def build_finetune_experiment(params, directory=None, db=None, images=None,
                              device=None):
    """params: the resolved fine-tune tree (network / learning / data /
    output). `directory` holds the checkpoints and events (none without
    it); `db` and `images` are a tuple database and its image paths, else
    `data.train.dataset.dataset_pkl` and `image_dir` name them.

    Returns the JAX package's keys {"models", "variables", "state", "step",
    "training", "loader", "events", "checkpoints", "dataset"} and {"stage",
    "schedule", "base_lr", "bucket"}: `variables` the networks' state
    dicts, `stage` the step's uint8 staging alone, `bucket` the padded side
    for `data.train.dataset.image_size`. The weights are seeded from
    `learning.training.seed` unless a local checkpoint is given. Runs on
    cuda unless `device="cpu"`."""
    dev = resolve_device(device)
    params = copy.deepcopy(params)
    net_cfg = params["network"]
    learn_cfg = params["learning"]
    train_cfg = dict(learn_cfg["training"])
    data_cfg = params.get("data") or {}
    # persisted with each checkpoint; a resume under another one is refused
    config_snapshot = copy.deepcopy({"validation": learn_cfg.get("validation"),
                                     "datasets": params.get("data")})
    seq = [s.strip() for s in net_cfg.get("sequence",
                                          "augment,embed").split(",")]
    if seq != ["augment", "embed"]:
        raise ValueError("sequence must be augment,embed, got %s" % seq)
    seed = int(train_cfg.get("seed", 0))

    augment_cfg = dict(net_cfg["augment"])
    augment_path = augment_cfg.pop("path", None)
    augment = build_single_net(augment_cfg, device="cpu")
    initialize_weights(augment.module, "normal_p2p", seed)
    _load_local(augment.module, augment_path, "augment")
    augment.module.to(dev).eval().requires_grad_(False)

    embed_cfg = dict(net_cfg["embed"])
    embed_path = embed_cfg.pop("path", None)
    embed = build_single_net(embed_cfg, device="cpu")
    _init_random(embed.module, seed + 1)
    load_pretrained(embed.module,
                    (embed_cfg.get("model") or {}).get("pretrained"),
                    "embed.model.pretrained")
    _load_local(embed.module, embed_path, "embed")
    embed.module.to(dev)
    models = {"augment": augment, "embed": embed}

    optimizer, base_lr = initialize_optimizer(
        dict(train_cfg["optimizer"]), embed.module.named_parameters(),
        embed_cfg.get("model", {}).get("architecture", ""))
    epochs = int(train_cfg.get("epochs", 1))
    schedule = initialize_schedule(epochs, dict(
        train_cfg.get("scheduler") or {"algorithm": "const"}))
    crit = dict(train_cfg.get("criterion")
                or {"loss": "contrastive", "margin": 0.75})
    fakebatch = bool((train_cfg.get("epoch_iteration") or {})
                     .get("fakebatch", True))
    ds_cfg = dict((data_cfg.get("train") or {}).get("dataset") or {})
    raw_step = supervised.build_finetune_step(
        models, optimizer, initialize_criterion(crit), fakebatch=fakebatch,
        augment_positions=_augment_positions(augment_cfg, ds_cfg))
    state = supervised.make_finetune_state(models, optimizer)

    # uint8 staging (finetune_build.py:199-224): the tuple transform is
    # elementwise after the resize, so /255 and the normalization run on
    # the device on the padded uint8 images, the masks are rebuilt from
    # each image's (h, w), and the band is re-zeroed as the host pad does
    gen_data = augment.data_params or GENERATOR_DATA
    _, dev_fn = split_device_transform(
        gen_data.get("transforms", ""),
        gen_data.get("mean_std", GENERATOR_DATA["mean_std"]))
    if dev_fn is None:
        raise NotImplementedError(
            "the augment net's transform %r has no elementwise device part; "
            "the port stages uint8 tuples only" % gen_data.get("transforms"))

    stage_flat = _stage_flat(dev_fn)

    def stage(imgs_u8, hws):
        """(T, S, H, W, 3) uint8 + (T, S, 2) valid sizes -> the step's
        (images, masks), on the tensors' device."""
        T, S = imgs_u8.shape[:2]
        y, masks = stage_flat(imgs_u8.flatten(0, 1), hws.flatten(0, 1))
        return (y.reshape((T, S) + tuple(y.shape[1:])),
                masks.reshape((T, S) + tuple(masks.shape[1:])))

    def step(state, imgs_u8, hws, labels, pass_mask):
        return raw_step(state, *stage(imgs_u8, hws), labels, pass_mask)

    # data parallelism over the process group (the JAX package's
    # finetune_build.py:226-230): the tuples split over the ranks, the
    # loss a sum over tuples, so the gradients are summed, not averaged
    loader_cfg = dict((data_cfg.get("train") or {}).get("loader") or {})
    step = mesh.maybe_data_parallel(
        step, train_cfg.get("parallel", True),
        int(loader_cfg.get("batch_size", 5) or 5), grad_reduction="sum",
        sync_batchnorm=False)
    data_parallel = getattr(step, "gandtr_dp", False)
    if data_parallel:
        mesh.attach_optimizers([optimizer])
    mesh.replicate_tree(models, optimizer)

    # --- mining, the tuple dataset and its loader
    image_size = int(ds_cfg.get("image_size", 362))
    if db is None and ds_cfg.get("dataset_pkl"):
        db, images = load_tuples_db(ds_cfg["dataset_pkl"],
                                    ds_cfg.get("split", "train"),
                                    ds_cfg.get("image_dir", ""))
    loader = dataset = None
    ratio, label = _parse_ratio((augment_cfg.get("runtime") or {})
                                .get("wrappers", ""))
    if db is not None:
        miner = TuplesMiner(
            db, nnum=int(ds_cfg.get("neg_num", 5)),
            qsize=int(float(ds_cfg.get("query_size", 2000))),
            poolsize=int(float(ds_cfg.get("pool_size", 22000))),
            seed=seed,
            qpool_size=(int(float(ds_cfg["qpool_size"]))
                        if "qpool_size" in ds_cfg else None),
            similar_exclude=ds_cfg.get("similar_exclude"),
            similar_include=ds_cfg.get("similar_include"),
            mark_easy=ds_cfg.get("mark_easy"),
            first_neg=ds_cfg.get("first_neg", "neg"), device=dev)
        dataset = TupleEpochDataset(db, images, image_size, miner,
                                    augment_ratio=ratio, augment_label=label)
        dataset.extract_fn = _make_extract_fn(
            state, images, image_size, stage_flat, ratio, label, dev)
        loader = Loader(dataset,
                        batch_size=int(loader_cfg.get("batch_size", 5)),
                        shuffle=True, drop_last=True,
                        num_workers=int(loader_cfg.get("num_workers", 6)))
    validations = []
    if learn_cfg.get("validation") and data_cfg.get("val") and db is not None:
        validations.append(_loss_validation(
            dict(learn_cfg["validation"]), dict(data_cfg["val"]), ds_cfg, db,
            images, state, image_size, ratio, label,
            float(crit.get("margin", 0.75)), dev))

    ckpt_cfg = dict(learn_cfg.get("checkpoints") or {})
    checkpoints = Checkpoints(
        directory,
        store_every=ckpt_cfg.get("store_every", 10) or 0,
        checkpoint_every=ckpt_cfg.get("checkpoint_every", 2) or 0,
        directory_epoch_regex=ckpt_cfg.get("directory_epoch_regex")) \
        if directory else None
    # without a validation there is no decisive criterion: _best follows
    # _last
    out_cfg = (params.get("output") or {}).get("learning", {})
    events = initialize_processor(
        out_cfg, directory=directory,
        decisive_criterion="val/learning/loss:total" if validations else None)

    # dispatch_chunk: the same steps in the same order; metrics are read
    # back once a chunk, and the loader prefetches past a chunk
    chunk = int(train_cfg.get("dispatch_chunk", 0) or 0)
    if chunk > 1 and data_parallel:
        warnings.warn("dispatch_chunk disabled: data-parallel step active")
        chunk = 0
    if chunk > 1 and loader is not None:
        loader.prefetch = max(loader.prefetch, chunk + 2)

    training = None
    if loader is not None:
        training = Training(
            step_fn=step, loader=loader, epochs=epochs, seed=seed,
            optimizers_base_lr={"embed": base_lr},
            schedules={"embed": schedule},
            events=events, checkpoints=checkpoints, frozen=("augment",),
            batch_to_args=lambda b: tuple(upload(a, dev) for a in b),
            config_snapshot=config_snapshot, chunk=chunk,
            validations=validations, profile_dir=out_cfg.get("profile"),
            net_params={name: {"model": cfg.get("model"),
                               "runtime": cfg.get("runtime")}
                        for name, cfg in (("augment", augment_cfg),
                                          ("embed", embed_cfg))})
        # mining reads the weights of the state it is handed each epoch
        training.state_hook = lambda s, epoch: \
            dataset.extract_fn.holder.__setitem__("state", s)

    return {"models": models,
            "variables": {k: m.module.state_dict() for k, m in models.items()},
            "state": state, "step": step, "training": training,
            "loader": loader, "events": events, "checkpoints": checkpoints,
            "dataset": dataset, "stage": stage, "schedule": schedule,
            "base_lr": base_lr, "bucket": generator_safe_bucket(image_size)}


def _stage_flat(dev_fn):
    """stage_flat((N, H, W, 3) uint8, (N, 2) valid sizes) -> (images,
    masks): the masks rebuilt from the sizes, /255 and `dev_fn` on the
    device, the pad band re-zeroed as the host pad does."""
    def stage_flat(imgs_u8, hws):
        H, W = imgs_u8.shape[1:3]
        rows = torch.arange(H, device=imgs_u8.device)[None, :, None]
        cols = torch.arange(W, device=imgs_u8.device)[None, None, :]
        masks = ((rows < hws[:, 0, None, None])
                 & (cols < hws[:, 1, None, None])).to(torch.float32)
        y = dev_fn(imgs_u8.to(torch.float32) / 255.0, mask=masks)
        return y * masks[..., None], masks
    return stage_flat


def _loss_validation(val_section, val_data, ds_cfg, db, images, state,
                     image_size, ratio, label, margin, device):
    """The LossValidation of a `learning.validation` section over the
    `data.val` split (the JAX package's finetune_build.py:285-354)."""
    vds_cfg = dict(val_data.get("dataset") or {})
    vsplit = vds_cfg.get("split", "val")
    vpkl = vds_cfg.get("dataset_pkl", ds_cfg.get("dataset_pkl"))
    vroot = vds_cfg.get("image_dir", ds_cfg.get("image_dir", ""))
    val_db, val_images = db, images
    if vpkl and (vsplit != ds_cfg.get("split", "train")
                 or vpkl != ds_cfg.get("dataset_pkl")):
        try:
            val_db, val_images = load_tuples_db(vpkl, vsplit, vroot)
        except KeyError as exc:
            warnings.warn("the tuple pickle has no %r split (%s): the "
                          "validation uses the train db" % (vsplit, exc))
    miner = TuplesMiner(
        val_db, nnum=int(vds_cfg.get("neg_num", 5)),
        qsize=int(min(float(vds_cfg.get("query_size", 200)), 1e6)),
        poolsize=int(min(float(vds_cfg.get("pool_size", 2000)), 1e6)),
        shuffle=False, device=device)
    dataset = TupleEpochDataset(val_db, val_images, image_size, miner,
                                augment_ratio=0.0)
    # the JAX package normalizes the val tuples with the generator's
    # fixed pipeline
    stage_flat = _stage_flat(split_device_transform(
        GENERATOR_DATA["transforms"], GENERATOR_DATA["mean_std"])[1])

    # mining goes through the train chain, its augmentation gate included
    dataset.extract_fn = _make_extract_fn(state, val_images, image_size,
                                          stage_flat, ratio, label, device)

    def val_loss(st, imgs_u8, hws, labels, pass_mask):
        x, masks = stage_flat(imgs_u8[0], hws[0])
        descs = st.models["embed"].apply(x, train=False, mask=masks)
        return L.contrastive_loss(descs.T, labels[0], num_tuples=1,
                                  margin=margin)

    return LossValidation(
        val_loss, Loader(dataset, batch_size=1, num_workers=1),
        frequency=val_section.get("frequency", 5),
        batch_to_args=lambda b: tuple(upload(a, device) for a in b),
        # contrastive is sum-reduced: reported per tuple
        criterion_mean_reduction=False,
        on_validate=lambda st: dataset.extract_fn.holder.__setitem__(
            "state", st))


def _make_extract_fn(state, images, image_size, stage_flat, augment_ratio,
                     augment_label, device):
    """Descriptors of dataset images for mining, through the training's
    augment + embed chain (traindataset.py mines with the trained network):
    `extract(idxs, label) -> (D, N)` host float32.

    The images whose name passes the md5 gate (and only under a label the
    gate's regex matches) go through the generator; the others take the
    chain with `model_positions=()`, so the outer CLAHE and meanstd
    wrappers still run on them. Each image's result does not depend on its
    batch, so the two partitions run apart, in batches of up to
    EXTRACT_BATCH, and their results go back into input order. A thread
    decodes the next batch while the device runs this one; the host waits
    once a partition. Under a process group each rank runs every N-th
    batch of a partition (the same batches, so the same descriptors bit for
    bit) and the descriptors are gathered back in input order."""
    holder = {"state": state}
    bucket = generator_safe_bucket(image_size)
    gate_re = re.compile(augment_label or "anc")

    def prep_u8(chunk):
        imgs, hws = zip(*(load_u8_padded(images[i], image_size, bucket)
                          for i in chunk))
        return np.stack(imgs), np.asarray(hws, np.int32)

    @torch.inference_mode()
    def forward(imgs_u8, hws, augmented):
        models = holder["state"].models
        x, masks = stage_flat(upload(imgs_u8, device), upload(hws, device))
        pmask = torch.full((x.shape[0],), augmented, dtype=torch.bool,
                           device=device)
        out = models["augment"].apply(
            x, ctx={"pass_mask": pmask}, train=True, mask=masks,
            model_positions=None if augmented else ())
        # the generator moved the valid rectangles of the rows it ran on
        x, masks = out if isinstance(out, tuple) else (out, masks)
        return models["embed"].apply(x, train=False, mask=masks)

    def run_partition(idxs, augmented):
        starts = list(range(0, len(idxs), EXTRACT_BATCH))
        owners = [mesh.strided_share(len(starts), r)
                  for r in range(mesh.world_size())]
        chunks = [idxs[starts[k]:starts[k] + EXTRACT_BATCH]
                  for k in owners[mesh.rank()]]
        outs = []
        if chunks:
            with ThreadPoolExecutor(1) as ex:
                fut = ex.submit(prep_u8, chunks[0])
                for nxt in chunks[1:] + [None]:
                    imgs_u8, hws = fut.result()
                    if nxt is not None:
                        fut = ex.submit(prep_u8, nxt)
                    outs.append(forward(imgs_u8, hws, augmented))
        vecs = torch.cat(outs).float() if outs else \
            torch.zeros((0, 0), device=device)
        if mesh.world_size() > 1:
            vecs = mesh.gather_positions(vecs, [
                [i for k in own for i in range(
                    starts[k], min(starts[k] + EXTRACT_BATCH, len(idxs)))]
                for own in owners])
        return vecs.cpu().numpy()

    def extract(idxs, label="anc-mine"):
        idxs = list(idxs)
        gate = bool(gate_re.match(label))
        flags = [gate and cir_hash_passthrough(metadata_name(images[i]),
                                               augment_ratio) for i in idxs]
        out = None
        for augmented in (True, False):
            positions = [k for k, f in enumerate(flags) if f == augmented]
            if not positions:
                continue
            vecs = run_partition([idxs[k] for k in positions], augmented)
            if out is None:
                out = np.empty((len(idxs), vecs.shape[1]), np.float32)
            out[np.asarray(positions)] = vecs
        return out.T

    extract.holder = holder
    return extract
