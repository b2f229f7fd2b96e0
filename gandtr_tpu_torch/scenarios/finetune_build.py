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
pmask (T, S) bool, all on the experiment's device. The validations of the
JAX package (a `learning.validation` section) are not ported yet.
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
from gandtr_tpu_torch.learning.training import Training
from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                metadata_name)
from gandtr_tpu_torch.models.init import initialize_weights

GENERATOR_DATA = {"transforms": "pil2np | totensor | normalize",
                  "mean_std": [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]}
EXTRACT_BATCH = 32   # images a mining extraction batch


def _load_local(module, path, what):
    """Load a local reference checkpoint into `module`; warn and keep the
    seeded weights when the file is not there (as the JAX package does)."""
    if not path:
        return
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

    def stage_flat(imgs_u8, hws):
        """(N, H, W, 3) uint8 + (N, 2) valid sizes -> (images, masks)."""
        H, W = imgs_u8.shape[1:3]
        rows = torch.arange(H, device=imgs_u8.device)[None, :, None]
        cols = torch.arange(W, device=imgs_u8.device)[None, None, :]
        masks = ((rows < hws[:, 0, None, None])
                 & (cols < hws[:, 1, None, None])).to(torch.float32)
        y = dev_fn(imgs_u8.to(torch.float32) / 255.0, mask=masks)
        return y * masks[..., None], masks

    def stage(imgs_u8, hws):
        """(T, S, H, W, 3) uint8 + (T, S, 2) valid sizes -> the step's
        (images, masks), on the tensors' device."""
        T, S = imgs_u8.shape[:2]
        y, masks = stage_flat(imgs_u8.flatten(0, 1), hws.flatten(0, 1))
        return (y.reshape((T, S) + tuple(y.shape[1:])),
                masks.reshape((T, S) + tuple(masks.shape[1:])))

    def step(state, imgs_u8, hws, labels, pass_mask):
        return raw_step(state, *stage(imgs_u8, hws), labels, pass_mask)

    # --- mining, the tuple dataset and its loader
    image_size = int(ds_cfg.get("image_size", 362))
    loader_cfg = dict((data_cfg.get("train") or {}).get("loader") or {})
    if db is None and ds_cfg.get("dataset_pkl"):
        db, images = load_tuples_db(ds_cfg["dataset_pkl"],
                                    ds_cfg.get("split", "train"),
                                    ds_cfg.get("image_dir", ""))
    loader = dataset = None
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
        ratio, label = _parse_ratio((augment_cfg.get("runtime") or {})
                                    .get("wrappers", ""))
        dataset = TupleEpochDataset(db, images, image_size, miner,
                                    augment_ratio=ratio, augment_label=label)
        dataset.extract_fn = _make_extract_fn(
            state, images, image_size, stage_flat, ratio, label, dev)
        loader = Loader(dataset,
                        batch_size=int(loader_cfg.get("batch_size", 5)),
                        shuffle=True, drop_last=True,
                        num_workers=int(loader_cfg.get("num_workers", 6)))
    if learn_cfg.get("validation") and data_cfg.get("val") and db is not None:
        raise NotImplementedError("the fine-tune's validations are not "
                                  "ported yet")

    ckpt_cfg = dict(learn_cfg.get("checkpoints") or {})
    checkpoints = Checkpoints(
        directory,
        store_every=ckpt_cfg.get("store_every", 10) or 0,
        checkpoint_every=ckpt_cfg.get("checkpoint_every", 2) or 0,
        directory_epoch_regex=ckpt_cfg.get("directory_epoch_regex")) \
        if directory else None
    # no validation: no decisive criterion, so _best follows _last
    events = initialize_processor(
        (params.get("output") or {}).get("learning", {}),
        directory=directory)

    # dispatch_chunk: the same steps in the same order; metrics are read
    # back once a chunk, and the loader prefetches past a chunk
    chunk = int(train_cfg.get("dispatch_chunk", 0) or 0)
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
    once a partition."""
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
        chunks = [idxs[i:i + EXTRACT_BATCH]
                  for i in range(0, len(idxs), EXTRACT_BATCH)]
        outs = []
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(prep_u8, chunks[0])
            for nxt in chunks[1:] + [None]:
                imgs_u8, hws = fut.result()
                if nxt is not None:
                    fut = ex.submit(prep_u8, nxt)
                outs.append(forward(imgs_u8, hws, augmented))
        return torch.cat(outs).float().cpu().numpy()

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
