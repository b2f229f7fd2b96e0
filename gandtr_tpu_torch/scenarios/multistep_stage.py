"""Multistep stage: descriptors of a whitening dataset, then whitening
learned from them (counterpart of gandtr_tpu/scenarios/multistep_stage.py;
the reference's stages/multistep.py).

    (meta,) = infer_and_learn_whitening(params, None)   # on cuda

params: whitening.yml's sections: `whitening: {type: lw | pca,
dataset_pkl, directory}`, and the infer stage's `network`, `data` and
`output`. The image paths come from the pickle's cids as
`cid[-2:]/cid[-4:-2]/cid[-6:-4]/cid` under `data.image_dir`; the learned
{"m", "P"} is pickled to `<directory>/whitening/<type>-<name>.pkl`, with
<name> the pickle's file name up to its first '-' (`lw-retrieval.pkl` for
retrieval-SfM-120k-whiten.pkl). An existing file is kept and the stage
skipped. Without a directory the whitening is returned instead.
"""
import os
import pickle

from gandtr_tpu_torch.device import resolve_device
from gandtr_tpu_torch.ops import whiten as whiten_ops
from gandtr_tpu_torch.parallel import mesh
from gandtr_tpu_torch.scenarios.infer_stage import infer
from gandtr_tpu_torch.utils.io import load_pickle, resolve_path


def infer_and_learn_whitening(params, data, device=None):
    """Returns ({"status": "skipped", "whitening_path"},) when the pickle
    exists, else ({"infer": the infer stage's metadata, "whitening_path",
    "whitening": {"m", "P"} or None when it was written},). Runs on cuda
    unless `device="cpu"`."""
    if data and data[0]:
        raise ValueError("infer_and_learn_whitening takes no input data")
    device = resolve_device(device)
    params = dict(params)
    whitening = dict(params.pop("whitening"))
    if whitening.keys() != {"type", "dataset_pkl", "directory"}:
        raise ValueError("whitening section keys %s" % sorted(whitening))

    path = None
    if whitening["directory"]:
        name = whitening["dataset_pkl"].rsplit("/", 1)[-1].split("-", 1)[0]
        path = os.path.join(resolve_path(whitening["directory"]),
                            "whitening", "%s-%s.pkl" % (whitening["type"],
                                                        name))
        if os.path.exists(path):
            return ({"status": "skipped", "whitening_path": path},)
        os.makedirs(os.path.dirname(path), exist_ok=True)

    pkl = load_pickle(resolve_path(whitening["dataset_pkl"]))
    # nested cid paths (multistep.py:26)
    paths = ["/".join([x[-2:], x[-4:-2], x[-6:-4], x]) for x in pkl["cids"]]
    infer_params = dict(params)
    infer_params["output"] = {**dict(params.get("output") or {}),
                              "type": "embedding"}
    (meta,) = infer(infer_params, (paths,), device=device)
    descriptors = meta.pop("vecs")      # (D, N), in `paths` order
    meta.pop("names", None)

    if whitening["type"] == "lw":
        cid_to_idx = {cid: i for i, cid in enumerate(pkl["cids"])}
        qidxs = [cid_to_idx[pkl["cids"][x]] for x in pkl["qidxs"]]
        pidxs = [cid_to_idx[pkl["cids"][x]] for x in pkl["pidxs"]]
        m, P = whiten_ops.whitenlearn_with_retry(descriptors, qidxs, pidxs)
    elif whitening["type"] == "pca":
        m, P = whiten_ops.pcawhitenlearn(descriptors)
    else:
        raise ValueError("whitening type %r" % whitening["type"])

    whit = {"m": m, "P": P}
    if path and mesh.is_writer():
        with open(path, "wb") as f:
            pickle.dump(whit, f)
    return ({"infer": meta, "whitening_path": path,
             "whitening": None if path else whit},)
