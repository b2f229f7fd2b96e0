"""Path resolution and pickle loading for local files (counterpart of
gandtr_tpu/utils/io.py::resolve_path and ::load_pickle).

`resolve_path` rewrites a relative path by the first matching rule; the
default rule roots it at $GANDTR_ROOT (or $CIRTORCH_ROOT), read at call time
as the reference does. This package downloads nothing: a URL passes through
`resolve_path` unchanged, and `load_pickle` refuses it.
"""
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


def load_pickle(path):
    """Unpickle a local file (a gnd or Lw pickle the user placed there)."""
    if "://" in str(path):
        raise ValueError("load_pickle takes local files only (this package "
                         "downloads nothing), got %r" % path)
    with open(path, "rb") as f:
        return pickle.load(f)
