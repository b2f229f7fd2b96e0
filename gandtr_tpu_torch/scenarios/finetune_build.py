"""Build the GeM fine-tune experiment of parameters/finetune.yml (counterpart
of gandtr_tpu/scenarios/finetune_build.py, its case without a tuple
database): augment (a frozen generator with the meanstd / CLAHE / ratio-gate
wrappers) -> embed (GeM-VGG16), contrastive loss, Adam.

Tuples arrive as uint8 images padded into a square bucket with each image's
valid (h, w), as the JAX package stages them: the step rebuilds the masks
on the device, applies /255 and the generator's normalization there, and
re-zeroes the pad band. Mining, the tuple dataset and its loader, epochs,
checkpoints, events and validation are not ported yet; the caller makes the
tuple batches.

    exp = build_finetune_experiment(params)           # on cuda
    state, metrics = exp["step"](exp["state"], imgs_u8, hws, labels, pmask)

imgs_u8 (T, S, H, W, 3) uint8, hws (T, S, 2) int32, labels (T, S) float,
pmask (T, S) bool, all on the experiment's device.
"""
import copy
import os
import re
import warnings

import torch

from gandtr_tpu_torch.data.cir_datasets import generator_safe_bucket
from gandtr_tpu_torch.data.transforms import split_device_transform
from gandtr_tpu_torch.device import resolve_device
from gandtr_tpu_torch.hub import _checkpoint_model_state, _init_random
from gandtr_tpu_torch.learning import supervised
from gandtr_tpu_torch.learning.criteria import initialize_criterion
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.learning.optimizers import initialize_optimizer
from gandtr_tpu_torch.learning.schedules import initialize_schedule
from gandtr_tpu_torch.models.init import initialize_weights

GENERATOR_DATA = {"transforms": "pil2np | totensor | normalize",
                  "mean_std": [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]}


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


def build_finetune_experiment(params, device=None):
    """params: the resolved fine-tune tree (network / learning / data).
    Returns {"models", "state", "step", "stage", "schedule", "base_lr",
    "bucket"}: `stage` is the step's uint8 staging alone, `bucket` the
    padded side for `data.train.dataset.image_size`. The weights are seeded from
    `learning.training.seed` unless a local checkpoint is given. Runs on
    cuda unless `device="cpu"`."""
    dev = resolve_device(device)
    params = copy.deepcopy(params)
    net_cfg = params["network"]
    train_cfg = dict(params["learning"]["training"])
    data_cfg = params.get("data") or {}
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
    schedule = initialize_schedule(int(train_cfg.get("epochs", 1)), dict(
        train_cfg.get("scheduler") or {"algorithm": "const"}))
    crit = dict(train_cfg.get("criterion")
                or {"loss": "contrastive", "margin": 0.75})
    fakebatch = bool((train_cfg.get("epoch_iteration") or {})
                     .get("fakebatch", True))
    ds_cfg = (data_cfg.get("train") or {}).get("dataset") or {}
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

    def stage(imgs_u8, hws):
        """(T, S, H, W, 3) uint8 + (T, S, 2) valid sizes -> the step's
        (images, masks), on the tensors' device."""
        T, S, H, W = imgs_u8.shape[:4]
        rows = torch.arange(H, device=imgs_u8.device)[None, None, :, None]
        cols = torch.arange(W, device=imgs_u8.device)[None, None, None, :]
        masks = ((rows < hws[:, :, 0, None, None])
                 & (cols < hws[:, :, 1, None, None])).to(torch.float32)
        x = imgs_u8.to(torch.float32) / 255.0
        y = dev_fn(x.reshape((T * S, H, W) + tuple(x.shape[4:])),
                   mask=masks.reshape(T * S, H, W))
        y = y.reshape((T, S, H, W) + tuple(y.shape[3:])) * masks[..., None]
        return y, masks

    def step(state, imgs_u8, hws, labels, pass_mask):
        return raw_step(state, *stage(imgs_u8, hws), labels, pass_mask)

    return {"models": models, "state": state, "step": step, "stage": stage,
            "schedule": schedule, "base_lr": base_lr,
            "bucket": generator_safe_bucket(
                int(ds_cfg.get("image_size", 362)))}
