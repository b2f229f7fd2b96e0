"""Validate stage: retrieval evaluation of a descriptor network
(counterpart of gandtr_tpu/scenarios/validate_stage.py), as
parameters/eval.yml drives it.

    (result,) = validate(params, None)                 # on cuda
    (result,) = validate(params, None, device="cpu")
    result["metadata"]["validation"]
    # {"config:data.shape_bucket": 64,
    #  "roxford5k/validation/score_avg:map_medium": ..., ...}

The network section gives the net (seeded weights with `path: null`, or a
local reference .pth) and its eval wrappers (`0_cirwhiten` with a local Lw
pickle, `1_cirmultiscale`); the data section the transforms, image size,
`shape_bucket` and `loader.batch_size`; the validation section the
datasets, as `{dir_main, datasets}` or the reference's
MultiCriterialValidation tree with a per-criterion `image_size`.

The uint8 images go to the device, where CLAHE and the normalization run
(data/transforms.py::split_device_transform): with a bucket, the masked
CLAHE of each image's rectangle (K4 on the card, one launch a batch), else
the static CLAHE (K1, one launch a batch).
"""
import numpy as np
import torch

from gandtr_tpu_torch.data.transforms import (initialize_transforms,
                                              split_device_transform)
from gandtr_tpu_torch.device import resolve_device
from gandtr_tpu_torch.eval.retrieval import (ShapeCachedExtractor,
                                             configdataset, evaluate_dataset)
from gandtr_tpu_torch.learning.wrappers import (CirMultiscaleAggregation,
                                                CirtorchWhiten,
                                                multiscale_msp)
from gandtr_tpu_torch.parallel import mesh
from gandtr_tpu_torch.scenarios.infer_stage import _load_network
from gandtr_tpu_torch.utils.io import load_pickle, resolve_path

DEFAULT_TRANSFORMS = "pil2np | apply_clahe:1.0 | totensor | normalize"
IMAGENET_MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]


def _eval_wrappers(wrappers_cfg, model, net_cfg, device):
    """The eval wrappers of a `{"eval": {"<i>_<name>": {...}}}` section in
    sorted key order, and the multiscale power."""
    wrappers, msp = [], 1.0
    if not isinstance(wrappers_cfg, dict):
        return wrappers, msp
    for key in sorted(wrappers_cfg.get("eval") or {}):
        cfg = dict(wrappers_cfg["eval"][key] or {})
        if key.endswith("cirwhiten"):
            if not cfg.get("whitening"):
                raise ValueError(
                    "%s: `whitening` is null; give the path of a local Lw "
                    "pickle ({'P', 'm'})" % key)
            lw = load_pickle(resolve_path(cfg["whitening"]))
            wrappers.append(CirtorchWhiten(P=lw["P"], m=lw["m"],
                                           dimensions=cfg.get("dimensions"),
                                           device=device))
        elif key.endswith("cirmultiscale"):
            wrappers.append(CirMultiscaleAggregation(
                scales=cfg.get("scales", True)))
            msp = multiscale_msp(model.loaded_model_cfg or
                                 net_cfg.get("model"), model.module)
    return wrappers, msp


def _plan(val_cfg, image_size):
    """[(name, dataset, image_size)] of both validation forms."""
    plan = [(ds, ds, image_size) for ds in (val_cfg.get("datasets") or ())]
    if plan:
        return plan
    for key, sub in val_cfg.items():
        if not isinstance(sub, dict):
            continue
        crit = dict(sub.get("criterion") or {})
        if crit.get("type", "cirdatasetap") != "cirdatasetap":
            raise NotImplementedError(
                "validation criterion %r" % crit.get("type"))
        plan.append((key, crit.get("dataset", key),
                     int(crit.get("image_size", image_size))))
    if not plan:
        plan = [(ds, ds, image_size) for ds in val_cfg
                if isinstance(ds, str)
                and ds not in ("type", "dir_main", "datasets",
                               "decisive_criterion")]
    return plan


def _eval_model(net_cfg, device):
    """(the WrappedNet with its eval wrappers on `device`, the multiscale
    power) of a network section."""
    net_cfg = dict(net_cfg)
    wrappers_cfg = (net_cfg.get("runtime") or {}).get("wrappers")
    if isinstance(wrappers_cfg, dict):
        # eval.yml's {"eval": {"<i>_<name>": {...}}} form, built here
        net_cfg.pop("runtime")
        model = _load_network(net_cfg, device)
        model.wrappers_eval, msp = _eval_wrappers(wrappers_cfg, model,
                                                  net_cfg, device)
    else:
        # a wrapper string (whitening.yml's "cirmultiscale:True"), built
        # with the net
        model = _load_network(net_cfg, device)
        msp = multiscale_msp(model.loaded_model_cfg or net_cfg.get("model"),
                             model.module)
    return model, msp


def _extract_devices(data_cfg, device):
    """The cards a single process extracts on round-robin
    (`data.parallel_extract`, on by default as in the JAX package): every
    visible card when there are several and no process group shares them
    out; else None."""
    if (not data_cfg.get("parallel_extract", True) or device.type != "cuda"
            or mesh.is_initialized() or torch.cuda.device_count() < 2):
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_eval(params, device):
    """The stage's set-up from its network and data sections: {"extractor":
    a ShapeCachedExtractor on `device`, "transform": the host transform its
    images take, "model": the WrappedNet with its eval wrappers, "pre": the
    device preprocessing (uint8 or float batch, mask) -> normalized batch,
    "ctx": the forward's context}. The infer stage's embedding output
    extracts through the same set-up. With several cards in one process the
    extractor goes round-robin over them, with a copy of the model on each
    (built from the same section and files); under a process group each
    rank extracts its share (eval/retrieval.py)."""
    data_cfg = dict(params.get("data") or {})
    model, msp = _eval_model(params["network"], device)
    devices = _extract_devices(data_cfg, device)
    models = {}
    if devices:
        # `model` serves its own card; each other card gets a copy
        home = device if device.index is not None \
            else torch.device("cuda", torch.cuda.current_device())
        models = {d: model if d == home
                  else _eval_model(params["network"], d)[0]
                  for d in devices}
    # transform defaults: the network's own data params (a checkpoint's),
    # else the published eval pipeline
    net_defaults = model.data_params if isinstance(model.data_params, dict) \
        else {}
    tf_str = data_cfg.get("transforms", net_defaults.get(
        "transforms", DEFAULT_TRANSFORMS))
    mean_std = data_cfg.get("mean_std", net_defaults.get(
        "mean_std", IMAGENET_MEAN_STD))
    transform, device_pre = split_device_transform(tf_str, mean_std)
    if device_pre is None:
        transform = initialize_transforms(tf_str, mean_std)

    def pre(x, mask=None):
        if device_pre is None:
            return x
        xf = x.float()
        if x.dtype == torch.uint8:
            xf = xf / 255.0
        return device_pre(xf, mask)

    ctx = {"msp": msp}
    shape_bucket = data_cfg.get("shape_bucket")

    def model_on(x):
        return models.get(x.device, model)

    if shape_bucket:
        def forward(x, mask, host_hw):
            return model_on(x).apply(pre(x, mask), ctx=ctx, mask=mask,
                                     host_hw=host_hw)
    else:
        def forward(x):
            return model_on(x).apply(pre(x), ctx=ctx)
    extractor = ShapeCachedExtractor(
        forward, shape_bucket=int(shape_bucket) if shape_bucket else None,
        device=device, devices=devices)
    return {"extractor": extractor, "transform": transform, "model": model,
            "pre": pre, "ctx": ctx}


def validate(params, data, device=None):
    """Evaluate each configured dataset; returns ({"metadata":
    {"validation": {...}}},) with `config:data.shape_bucket` and
    `<name>/validation/score_avg:<metric>` for each dataset's mAPs. Runs on
    cuda unless `device="cpu"`."""
    dev = resolve_device(device)
    np.random.seed(0)       # the stage's fixed seed, as the reference's
    setup = build_eval(params, dev)
    data_cfg = dict(params.get("data") or {})
    val_cfg = dict(params["validation"])
    image_size = int(data_cfg.get("image_size", 1024))
    batch_size = int((data_cfg.get("loader") or {}).get("batch_size", 1))
    shape_bucket = setup["extractor"].shape_bucket

    metadata = {"config:data.shape_bucket": shape_bucket}
    dir_main = resolve_path(val_cfg.get("dir_main", "data/test"))
    for name, ds, imsize in _plan(val_cfg, image_size):
        cfg = configdataset(ds, dir_main)
        metrics, _, _, _ = evaluate_dataset(
            setup["extractor"], cfg, imsize, setup["transform"],
            batch_size=batch_size)
        for mk, mv in metrics.items():
            metadata[f"{name}/validation/score_avg:{mk}"] = mv
        print(">> %s: %s" % (ds, {k: round(100 * v, 2)
                                  for k, v in metrics.items()}))
    return ({"metadata": {"validation": metadata}},)
