"""The infer stage and the network loader of the scenario stages
(counterpart of gandtr_tpu/scenarios/infer_stage.py::infer and
::_load_network).

    (meta,) = infer(params, (names,))                  # on cuda
    meta["vecs"]     # (D, N) float32 descriptors, in the order of `names`

Only the `embedding` output is ported: the images go through the validate
stage's extractor (with `data.shape_bucket`, padded buckets and masked
CLAHE, K4 on the card; without it exact shapes and K1). The `image` output
(a generator's images written to disk) is not ported yet.
"""
import pickle

import numpy as np
import torch

from gandtr_tpu_torch.data.datasets import path_join
from gandtr_tpu_torch.data.transforms import seed_transforms
from gandtr_tpu_torch.device import resolve_device
from gandtr_tpu_torch.eval.retrieval import extract_vectors
from gandtr_tpu_torch.hub import (_checkpoint_data_params,
                                  _checkpoint_model_state,
                                  _checkpoint_net_state, _init_random)
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.utils.io import resolve_path


def infer(params, data, device=None):
    """params: {network: {path | model, runtime}, data: {image_dir,
    image_size, shape_bucket, transforms, mean_std, loader}, output: {type:
    embedding}}; data[0]: the image names, joined to `data.image_dir` as
    the reference's path_join does. Returns ({"count", "vecs" (D, N) in
    name order, "names"},). Runs on cuda unless `device="cpu"`."""
    # validate_stage imports this module for _load_network
    from gandtr_tpu_torch.scenarios.validate_stage import build_eval
    dev = resolve_device(device)
    # the stage's fixed seed, as the reference's (stages/infer.py:20-21)
    np.random.seed(0)
    seed_transforms(0)
    params = dict(params)
    names = list(data[0]) if data else []
    out_type = dict(params.get("output") or {}).get("type", "image")
    if out_type != "embedding":
        raise NotImplementedError(
            "infer output %r is not ported yet; only `embedding` is"
            % out_type)
    if params.get("forward"):
        raise NotImplementedError("infer's `forward` section is not ported "
                                  "yet")
    data_cfg = dict(params.get("data") or {})
    setup = build_eval({"network": params["network"], "data": data_cfg},
                       dev)
    image_dir = resolve_path(data_cfg.get("image_dir", ""))
    paths = [path_join(image_dir, n) for n in names]
    image_size = data_cfg.get("image_size")
    batch_size = int((data_cfg.get("loader") or {}).get("batch_size", 8))
    vecs = extract_vectors(setup["extractor"], paths,
                           int(image_size) if image_size else None,
                           setup["transform"], batch_size=batch_size)
    return ({"count": len(names), "vecs": vecs, "names": names},)


def _load_network(net_cfg, device):
    """A WrappedNet on `device` from a SingleNetwork section: the built net
    with seeded weights (`path: null`), a reference `.pth` checkpoint, or
    the port's own network file (`learning/checkpoints.py`, e.g.
    `epochs/embed_best.ckpt`: {"type", "frozen", "network_params",
    "model_state"}). URLs are refused: this package downloads nothing.

    A config without a `model` section (path only) takes the checkpoint's
    `network_params.model`, and the checkpoint's data params under its own
    `runtime.data` (the config's keys win), as the reference does. The
    effective model config is kept as `net.loaded_model_cfg`."""
    net_cfg = dict(net_cfg)
    net_cfg.pop("type", None)
    path = net_cfg.pop("path", None)
    net_state = None
    if path:
        path = resolve_path(str(path))
        if "://" in path:
            raise NotImplementedError(
                "network checkpoint %r: only local files load (this package "
                "downloads nothing)" % path)
        try:
            # the port's own files hold tensors and plain containers only
            state = torch.load(path, map_location="cpu",
                               weights_only=not path.endswith((".pth",
                                                               ".pt")))
        except pickle.UnpicklingError as e:
            raise ValueError(
                "network checkpoint %r is not a torch file: a reference "
                ".pth or the port's own network file loads, the JAX "
                "package's flax checkpoints do not" % path) from e
        net_state = _checkpoint_net_state(state)
        if "model" not in net_cfg:
            ckpt_params = net_state.get("network_params") or {}
            if "model" in ckpt_params:
                net_cfg["model"] = dict(ckpt_params["model"])
            ck_data = _checkpoint_data_params(net_state, {})
            if ck_data:
                rt = dict(net_cfg.get("runtime") or {})
                rt["data"] = {**ck_data, **(rt.get("data") or {})}
                net_cfg["runtime"] = rt
    net = build_single_net(net_cfg, device="cpu")
    if net_state is None:
        _init_random(net.module, 0)
    else:
        # every parameter of the net must come from the checkpoint; keys it
        # has beyond them are ignored, as in the JAX package
        missing, _ = net.module.load_state_dict(
            _checkpoint_model_state(net_state), strict=False)
        if missing:
            raise KeyError("checkpoint %r lacks %s" % (path, missing))
    net.module.to(device).eval()
    net.loaded_model_cfg = dict(net_cfg.get("model") or {})
    return net
