"""Weights carried across from the JAX package's models.

`from_jax_variables` turns a JAX `variables` tree (nested dicts of numpy
arrays: `params`, and `batch_stats` where there is a BatchNorm) into a
PyTorch `state_dict` with the reference's torch names: the inverse of the
JAX package's torch importer (gandtr_tpu/utils/torch_import.py).

GeM nets (models/retrieval.py):

    backbone/features_<i>/conv/kernel (3, 3, I, O) -> features.<i>.weight (O, I, 3, 3)
    backbone/features_<i>/conv/bias                 -> features.<i>.bias
    gem_p (1,), or (dim,) for gemmp                 -> pool.p
    whiten|lwhiten/kernel (in, out)                 -> whiten|lwhiten.weight (out, in)
    whiten|lwhiten/bias                             -> whiten|lwhiten.bias

and the ResNet backbones, torchvision's layout (`features.0` conv1,
`features.1` bn1, `features.<3+l>` layer<l>), with BatchNorm as below:

    backbone/conv1/conv/kernel                      -> features.0.weight
    backbone/bn1/scale, bias; batch_stats mean, var -> features.1.weight, bias, running_mean, running_var
    backbone/layer<l>_<b>/conv<i>/conv/kernel       -> features.<3+l>.<b>.conv<i>.weight
    backbone/layer<l>_<b>/bn<i>/...                 -> features.<3+l>.<b>.bn<i>....
    backbone/layer<l>_<b>/downsample_<j>/...        -> features.<3+l>.<b>.downsample.<j>....

Generators (models/generators.py), `<name>_<i>` -> `<name>.<i>`, the `conv`
wrapper level dropped:

    model_10/conv_block_1/conv/kernel (kh, kw, I, O) -> model.10.conv_block.1.weight (O, I, kh, kw)
    model_19/kernel (kh, kw, I, O), a ConvTranspose  -> model.19.weight (I, O, kh, kw)
    model_2/scale, model_2/bias (BatchNorm)          -> model.2.weight, model.2.bias
    batch_stats: model_2/mean, model_2/var           -> model.2.running_mean, model.2.running_var

and each BatchNorm gets `num_batches_tracked` = 0, which torch's state has
and JAX's has not, so the result loads with `strict=True`.

The fine-tune tree {"augment": variables, "embed": variables} (the JAX
fine-tune state's `variables`) gives {"augment": state_dict, "embed":
state_dict}, the generator's batch statistics and the GeM `p` included.
"""
import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _retrieval_key(path):
    if path == ("gem_p",):
        return "pool.p"
    head = path[1] if path[0] == "backbone" else path[0]
    if head.startswith("features_"):
        return "features.%s.%s" % (head.split("_")[1], _LEAF[path[-1]])
    if path[0] == "backbone":
        return _resnet_key(path[1:])
    if head in ("whiten", "lwhiten"):
        return "%s.%s" % (head, _LEAF[path[-1]])
    return None


def _resnet_key(path):
    leaf = _LEAF[path[-1]]
    head = path[0]
    if head == "conv1":
        return "features.0.%s" % leaf
    if head == "bn1":
        return "features.1.%s" % leaf
    if head.startswith("layer"):
        layer, block = head[len("layer"):].split("_")
        inner = path[1]
        if inner.startswith("downsample_"):
            inner = "downsample." + inner.split("_")[1]
        return "features.%d.%s.%s.%s" % (3 + int(layer), block, inner, leaf)
    return None


def _torch_key(path):
    key = _retrieval_key(path)
    if key is not None:
        return key
    parts = []
    for p in path[:-1]:
        head, _, tail = p.rpartition("_")
        if p == "conv":  # the JAX Conv wrapper's level, absent in torch
            continue
        parts += [head, tail] if head and tail.isdigit() else [p]
    if not parts or path[-1] not in _LEAF:
        raise KeyError("no torch name for JAX parameter %s" % "/".join(path))
    return ".".join(parts + [_LEAF[path[-1]]])


def _layout(path, value):
    v = np.asarray(value, np.float32)
    if v.ndim == 4:
        if len(path) > 1 and path[-2] == "conv":
            return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        return v.transpose(2, 3, 0, 1)  # ConvTranspose (kh, kw, I, O) -> IOHW
    if v.ndim == 2:
        return v.T  # Dense (in, out) -> Linear (out, in)
    return v


def from_jax_variables(variables):
    """{'params': {...}[, 'batch_stats': {...}]} of numpy arrays ->
    {torch name: tensor}; a tree of such trees by net name (the fine-tune's
    {'augment', 'embed'}) -> {net name: state_dict}."""
    if "params" not in variables:
        return {name: from_jax_variables(v) for name, v in variables.items()}
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            key = _torch_key(path)
            out[key] = torch.from_numpy(np.array(_layout(path, value)))
            if key.endswith(".running_mean"):
                out[key[:-len("running_mean")] + "num_batches_tracked"] = (
                    torch.tensor(0, dtype=torch.int64))
    return out
