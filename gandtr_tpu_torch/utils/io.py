"""Path resolution, file hashes and local file loading (counterpart of
gandtr_tpu/utils/io.py).

`resolve_path` rewrites a relative path by the first matching rule; the
default rule roots it at $GANDTR_ROOT (or $CIRTORCH_ROOT), read at call time
as the reference does. This package downloads nothing: a URL passes through
`resolve_path` unchanged, and `fetch`, `load_pickle` and
`load_torch_checkpoint` refuse it (put the file in place and give its
path). `sha256_of` and `embedded_sha_prefix` are the reference's content
checks, `normalize_network_checkpoint` its network-file layouts.
"""
import hashlib
import os
import pickle
import re


def _default_rules():
    return [("^", os.environ.get("GANDTR_ROOT",
                                 os.environ.get("CIRTORCH_ROOT", "")))]


def resolve_path(path, rules=None):
    """Rewrite a path by the first matching (pattern, replacement) rule;
    absolute paths and URLs pass through, `$VAR`s are expanded."""
    if path is None:
        return None
    path = os.path.expandvars(path)
    if path.startswith(("http://", "https://")) or os.path.isabs(path):
        return path
    for pattern, repl in (rules if rules is not None else _default_rules()):
        if re.search(pattern, path):
            return re.sub(pattern, repl.rstrip("/") + "/" if repl else "",
                          path)
    return path


def sha256_of(path):
    """The hex sha256 of a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def embedded_sha_prefix(name):
    """The reference's file-name hash convention (fs_driver.py:101-107):
    'name-<sha256 hex prefix, 8 or more>.ext' -> the prefix, else None."""
    m = re.search(r".*-([a-f0-9]{8,})\.[a-zA-Z0-9]{2,}$", name)
    return m.group(1) if m else None


def fetch(path, sha256=None):
    """The local path of `path`: a local file passes through (checked
    against `sha256` when given); a URL raises, since this package
    downloads nothing (the JAX package's fetch downloads it into a
    cache)."""
    path = str(path)
    if "://" in path:
        raise ValueError("%s is a URL: this package downloads nothing; put "
                         "the file in place and give its path" % path)
    if sha256 and sha256_of(path) != sha256:
        raise IOError("sha256 mismatch for %s" % path)
    return path


def load_pickle(path):
    """Unpickle a local file (a gnd or Lw pickle the user placed there)."""
    if "://" in str(path):
        raise ValueError("load_pickle takes local files only (this package "
                         "downloads nothing), got %r" % path)
    with open(path, "rb") as f:
        return pickle.load(f)


def load_torch_checkpoint(path):
    """A local torch checkpoint (or a plain pickle) with its tensors as
    numpy arrays, as the JAX package's loader returns it."""
    import numpy as np
    import torch
    local = fetch(path)
    try:
        obj = torch.load(local, map_location="cpu", weights_only=False)
    except Exception:
        with open(local, "rb") as f:
            obj = pickle.load(f)

    def conv(o):
        if isinstance(o, torch.Tensor):
            return np.asarray(o.detach().cpu().numpy())
        if isinstance(o, dict):
            return {k: conv(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(conv(v) for v in o)
        return o
    return conv(obj)


def normalize_network_checkpoint(state):
    """A network checkpoint in the reference's in-memory layout {"net":
    {...}, <included net>: {...}, ...} (checkpoints.py:209-220). Takes the
    flat reference file {"type", "frozen", "network_params", "model_state"
    [, "_networks_included"]}, an already wrapped {"net": ...} dict, or a
    plain state dict (wrapped as {"net": {"model_state": ...}})."""
    if not isinstance(state, dict):
        raise TypeError("checkpoint is not a dict: %r" % type(state))
    if "net" in state:
        out = dict(state)
        net = dict(out["net"])
        out["net"] = net
        out.update(_included(net))
        return out
    if "model_state" in state:
        net = dict(state)
        return {"net": net, **_included(net)}
    return {"net": {"model_state": state}}


def _included(net):
    """Pop a network file's `_networks_included` (its sibling nets)."""
    included = net.pop("_networks_included", {}) or {}
    if "net" in included:
        raise ValueError("an included network is named 'net'")
    return included
