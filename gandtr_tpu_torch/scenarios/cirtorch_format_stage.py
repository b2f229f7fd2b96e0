"""Stages for checkpoints in the original cirtorch layout (counterpart of
gandtr_tpu/scenarios/cirtorch_format_stage.py; the reference's
mdir/stages/cirtorch_format/test.py): {"state_dict", "meta"}.

- `load_cirtorch_network(path, device)`: a GemRetrievalNet from such a
  file. The port's modules keep cirtorch's parameter names, so its
  state_dict loads as it is.
- `embed`: descriptors of an image list through such a network.
- `learn_whitening`: Lw from embedded query / positive pairs.
- `convert_contained_net`: one network of the port's own checkpoint (a
  network file {"model_state", ...}, or a dict of them by name) as a
  cirtorch-layout pickle of numpy arrays: the keys the JAX package's
  retrieval key map writes (the net's parameters and batch-norm
  statistics, not torch's batch counters).
"""
import os
import pickle
import zipfile

import numpy as np
import torch

from gandtr_tpu_torch.utils.io import resolve_path


def _load_file(path):
    """A torch.save file (zip, or the legacy form) or a plain pickle, as
    convert_contained_net writes in either package."""
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, int):  # the legacy torch form opens with one
            return obj
    return torch.load(path, map_location="cpu", weights_only=False)


def load_cirtorch_network(path, device=None):
    """(module on `device` in eval mode, meta) from {'state_dict',
    'meta': {architecture, pooling, local_whitening, whitening, ...}}.
    Parameters the file lacks keep their seeded initial values, as in the
    JAX package (strict=False)."""
    from gandtr_tpu_torch.device import resolve_device
    from gandtr_tpu_torch.hub import _init_random
    from gandtr_tpu_torch.models import initialize_model
    dev = resolve_device(device)
    path = resolve_path(path)
    if "://" in path:
        raise NotImplementedError("cirtorch network %r: only local files "
                                  "load (this package downloads nothing)"
                                  % path)
    state = _load_file(path)
    meta = state.get("meta", {})
    module = initialize_model({
        "architecture": "cirnet",
        "cir_architecture": meta.get("architecture", "vgg16"),
        "pooling": meta.get("pooling", "gem"),
        "local_whitening": bool(meta.get("local_whitening", False)),
        "whitening": bool(meta.get("whitening", False))})
    _init_random(module, 0)
    module.load_state_dict({k: torch.as_tensor(np.asarray(v))
                            for k, v in state["state_dict"].items()},
                           strict=False)
    return module.to(dev).eval(), meta


def embed(params, data, device=None):
    """Descriptors of the image names in data[0] (joined to `image_dir`),
    resized to `image_size` (1024), through a cirtorch-format network;
    written to `output` ({"names", "vecs"} pickle) when given. Returns
    ({"count", "vecs" (D, N)},). Runs on cuda unless `device="cpu"`."""
    from gandtr_tpu_torch.data.datasets import path_join
    from gandtr_tpu_torch.data.transforms import initialize_transforms
    from gandtr_tpu_torch.eval.retrieval import (ShapeCachedExtractor,
                                                 extract_vectors)
    params = dict(params)
    net_path = params.pop("network_path")
    image_size = int(params.pop("image_size", 1024))
    image_dir = resolve_path(params.pop("image_dir", ""))
    output = params.pop("output", None)
    module, meta = load_cirtorch_network(net_path, device)
    transform = initialize_transforms(
        params.pop("transforms", "pil2np | totensor | normalize"),
        params.pop("mean_std", [meta.get("mean", [0.485, 0.456, 0.406]),
                                meta.get("std", [0.229, 0.224, 0.225])]))

    extractor = ShapeCachedExtractor(lambda x: module(x.float()),
                                     device=next(module.parameters()).device)
    names = list(data[0]) if data else []
    vecs = extract_vectors(extractor, [path_join(image_dir, n)
                                       for n in names], image_size, transform)
    if output:
        output = resolve_path(output)
        os.makedirs(os.path.dirname(output), exist_ok=True)
        with open(output, "wb") as f:
            pickle.dump({"names": names, "vecs": vecs}, f)
    return ({"count": len(names), "vecs": vecs},)


def learn_whitening(params, data):
    """Lw whitening from data[0], (D, N) descriptors, and the `qidxs` /
    `pidxs` pairs; written to `output` ({"m", "P"} pickle) when given.
    Host numpy, as the JAX package's."""
    from gandtr_tpu_torch.ops.whiten import whitenlearn_with_retry
    params = dict(params)
    output = params.pop("output", None)
    m, P = whitenlearn_with_retry(np.asarray(data[0]), params.pop("qidxs"),
                                  params.pop("pidxs"))
    whit = {"m": m, "P": P}
    if output:
        output = resolve_path(output)
        os.makedirs(os.path.dirname(output), exist_ok=True)
        with open(output, "wb") as f:
            pickle.dump(whit, f)
    return ({"whitening": output or whit},)


_RETRIEVAL_PREFIXES = ("features.", "pool.", "lwhiten.", "whiten.")


def convert_contained_net(params, data):
    """The network `network` (default "embed") of the port's checkpoint at
    `input_path` as a cirtorch-format pickle at `output_path`: {"state_dict":
    {cirtorch key: numpy array}, "meta": params["meta"]}."""
    from gandtr_tpu_torch.hub import _checkpoint_net_state
    params = dict(params)
    in_path = resolve_path(params.pop("input_path"))
    out_path = resolve_path(params.pop("output_path"))
    net_name = params.pop("network", "embed")
    meta = dict(params.pop("meta", {}))

    state = _load_file(in_path)
    if isinstance(state, dict) and "model_state" not in state \
            and "net" not in state:
        # a container of networks by name
        if net_name not in state:
            raise KeyError("checkpoint has no model_state and no network "
                           "%r (has: %s)" % (net_name, sorted(state)))
        state = state[net_name]
    model_state = _checkpoint_net_state(state)["model_state"]
    state_dict = {k: np.asarray(torch.as_tensor(v).cpu())
                  for k, v in model_state.items()
                  if k.startswith(_RETRIEVAL_PREFIXES)
                  and not k.endswith("num_batches_tracked")}
    if not state_dict:
        raise ValueError("convert_contained_net produced an empty state_dict "
                         "for network %r: no retrieval-net key" % net_name)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump({"state_dict": state_dict, "meta": meta}, f)
    return ({"output_path": out_path, "keys": len(state_dict)},)
