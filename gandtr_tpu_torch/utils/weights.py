"""Weights carried across from the JAX package's models.

`from_jax_variables` turns a JAX GeM-net `variables` tree (nested dicts of
numpy arrays) into a PyTorch `state_dict` for models/retrieval.py: the
inverse of the JAX package's torch importer for retrieval nets.

    backbone/features_<i>/conv/kernel (3, 3, I, O) -> features.<i>.weight (O, I, 3, 3)
    backbone/features_<i>/conv/bias                 -> features.<i>.bias
    gem_p (1,)                                      -> pool.p
    whiten|lwhiten/kernel (in, out)                 -> whiten|lwhiten.weight (out, in)
    whiten|lwhiten/bias                             -> whiten|lwhiten.bias
"""
import numpy as np
import torch


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path):
    if path == ("gem_p",):
        return "pool.p"
    leaf = {"kernel": "weight", "bias": "bias"}[path[-1]]
    head = path[1] if path[0] == "backbone" else path[0]
    if head.startswith("features_"):
        return "features.%s.%s" % (head.split("_")[1], leaf)
    if head in ("whiten", "lwhiten"):
        return "%s.%s" % (head, leaf)
    raise KeyError("no torch name for JAX parameter %s" % "/".join(path))


def _layout(value):
    v = np.asarray(value, np.float32)
    if v.ndim == 4:
        return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if v.ndim == 2:
        return v.T  # Dense (in, out) -> Linear (out, in)
    return v


def from_jax_variables(variables):
    """{'params': {...}} of numpy arrays -> {torch name: float32 tensor}."""
    return {_torch_key(path): torch.from_numpy(np.array(_layout(value)))
            for path, value in _walk(variables["params"])}
