"""The whitening stages of the scenarios (counterpart of
gandtr_tpu/scenarios/stages.py; the reference's mdir/stages/whiten.py),
with the uniform `(params, data) -> (metadata, *data)` signature.
Descriptors are numpy (D, N) matrices, one column a descriptor, as the
infer stage's `vecs`; learning runs on the host in float64
(ops/whiten.py).
"""
import os
import pickle

import numpy as np
import torch

from gandtr_tpu_torch.ops import whiten as whiten_ops
from gandtr_tpu_torch.parallel import mesh
from gandtr_tpu_torch.utils.io import load_pickle, resolve_path


def whiten_stage(params, data):
    """Apply a learned whitening ({whitening: a pickle path or {"m", "P"},
    dimensions}) to data[0]; a null whitening passes the data through."""
    params = dict(params)
    lw = params.pop("whitening")
    dimensions = params.pop("dimensions", None)
    assert not params, params
    if not lw:
        return {"status": "No whitening applied"}, *data
    if isinstance(lw, str):
        lw = load_pickle(resolve_path(lw))
    out = whiten_ops.whitenapply(torch.from_numpy(np.asarray(data[0])),
                                 torch.from_numpy(np.asarray(lw["m"])),
                                 torch.from_numpy(np.asarray(lw["P"])),
                                 dimensions)
    return {}, out.numpy()


def _store(result, output):
    """Pickle `result` at `output` if given; the metadata's `whitening`."""
    if not output:
        return result
    output = resolve_path(output)
    if mesh.is_writer():
        os.makedirs(os.path.dirname(output), exist_ok=True)
        with open(output, "wb") as f:
            pickle.dump(result, f)
    return output


def learn_lw_whitening(params, data):
    """Lw whitening from data[0] and {qidxs, pidxs}, retried on a
    linear-algebra failure; pickled to `output` when given."""
    params = dict(params)
    qidxs = params.pop("qidxs")
    pidxs = params.pop("pidxs")
    output = params.pop("output", None)
    assert not params, params
    vecs = np.asarray(data[0])
    m, P = whiten_ops.whitenlearn_with_retry(vecs, qidxs, pidxs)
    return {"whitening": _store({"m": m, "P": P}, output)}, vecs


def learn_pca_whitening(params, data):
    """PCA whitening of data[0], with the optional eigenvalue `shrink`."""
    params = dict(params)
    shrink = params.pop("shrink", None)
    output = params.pop("output", None)
    assert not params, params
    vecs = np.asarray(data[0])
    m, P = whiten_ops.pcawhitenlearn(vecs, shrink)
    return {"whitening": _store({"m": m, "P": P}, output)}, vecs


def paste_pca_normalize(params, data):
    """The data's matrices stacked feature-wise; with `dimensions`, the
    scalar mean taken off and the stack projected on its top eigenvectors
    (V V^T, keeping its size), as the reference does; then each column
    L2-normalized without eps."""
    params = dict(params)
    dimensions = params.pop("dimensions") or None
    assert not params, params
    arrays = [np.asarray(d) for d in data]
    if arrays[0].shape in ((0,), (0, 0)):
        return {}, arrays[0]
    assert len({a.shape[1] for a in arrays}) == 1
    value = np.concatenate(arrays, axis=0)
    if dimensions:
        value = value - np.mean(value)
        eigval, eigvec = np.linalg.eig(value.dot(value.T))
        vecs = eigvec[:, np.argsort(eigval)[-dimensions:]]
        value = vecs.dot(vecs.T).dot(value)
    with np.errstate(invalid="ignore", divide="ignore"):
        return {}, value / np.linalg.norm(value, axis=0, keepdims=True)


def l2_normalize(params, data):
    """Each column of data[0] L2-normalized without eps: a zero or NaN
    column (a missing image) becomes NaN, as in the reference."""
    assert not params
    vecs = np.asarray(data[0])
    with np.errstate(invalid="ignore", divide="ignore"):
        return {}, vecs / np.linalg.norm(vecs, axis=0, keepdims=True)


FUNCTIONS = {
    "gandtr_tpu.stages.whiten.whiten": whiten_stage,
    "gandtr_tpu.stages.whiten.learn_lw_whitening": learn_lw_whitening,
    "gandtr_tpu.stages.whiten.learn_pca_whitening": learn_pca_whitening,
    "gandtr_tpu.stages.whiten.paste_pca_normalize": paste_pca_normalize,
    "gandtr_tpu.stages.whiten.l2_normalize": l2_normalize,
}
