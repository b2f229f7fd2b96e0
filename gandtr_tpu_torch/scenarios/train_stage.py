"""The train stage: `train(params, data, device=None) -> (metadata,)`
(counterpart of gandtr_tpu/scenarios/train_stage.py; the reference's
stages/train.py:12-47).

It builds the learning of the scenario section, resumes from the newest
epoch of its checkpoint directory, runs the epochs and returns the stage
metadata. A `NetworkSet` network is GAN training (scenarios/build.py, the
HED^N-GAN family), a `CirSequentialNetwork` the GeM fine-tune
(scenarios/finetune_build.py). `epochs: 0` writes the untrained networks
as `<name>_notrain.ckpt` and trains nothing. Runs on cuda unless
`device="cpu"`.

    (meta,) = train(params, ())                   # train_hedngan.yml's tree
    meta["metrics"]["train/learning/total"]       # the last epoch's mean
"""
import torch

from gandtr_tpu_torch.device import resolve_device
from gandtr_tpu_torch.utils.io import resolve_path
from gandtr_tpu_torch.utils.stats import CodeVersion, ResourceUsage


def train(params, data=None, device=None):
    """params: the resolved train tree (network / learning / data /
    output); `data` is unused, as in the reference's GAN and fine-tune
    stages."""
    dev = resolve_device(device)
    params = dict(params)
    params.pop("sample_hw", None)   # the JAX package's init shape
    if (params.get("learning") or {}).get("training", {}).get("debug"):
        torch.autograd.set_detect_anomaly(True)
    directory = resolve_path((params.get("learning") or {})
                             .get("checkpoints", {}).get("directory"))
    net_type = (params.get("network") or {}).get("type", "NetworkSet")
    if net_type == "NetworkSet":
        from gandtr_tpu_torch.scenarios.build import build_gan_experiment
        exp = build_gan_experiment(params, directory=directory, device=dev)
        if exp["training"] is None:
            raise ValueError("the train stage needs a data.train section")
    elif net_type in ("CirSequentialNetwork", "SequentialNetwork"):
        from gandtr_tpu_torch.scenarios.finetune_build import \
            build_finetune_experiment
        exp = build_finetune_experiment(params, directory=directory,
                                        device=dev)
        if exp["training"] is None:
            raise ValueError("the train stage needs a tuple database "
                             "(data.train.dataset.dataset_pkl)")
    else:
        raise NotImplementedError("network type %s" % net_type)
    usage = ResourceUsage(dev)
    training = exp["training"]
    state, start_epoch = training.resume_or_start(exp["state"])
    if training.epochs <= 0 and start_epoch == 1:
        if training.checkpoints:
            training.checkpoints.save_notrain(
                {name: training._net_file(state, name)
                 for name in state.models})
        return ({},)
    training.run(state, start_epoch=start_epoch)
    return (_stage_metadata(exp["events"], directory, usage),)


def _stage_metadata(events, directory, usage):
    """The stage metadata of the reference's learning: `metrics`, the last
    epoch's flat values merged with the reference's per-epoch key forms
    (`events.ref_metadata`, whose keys all carry a ':' or a suffix the
    flat ones lack); `metrics_series`, each metric's per-epoch values; the
    best epoch; the resources used; the code version; the directory."""
    series = {key: [by_epoch[e] for e in sorted(by_epoch)]
              for key, by_epoch in events.metadata.metrics.items()
              if by_epoch}
    metrics = dict(events.history[-1]["metrics"] if events.history else {})
    metrics.update(events.ref_metadata())
    return {"metrics": metrics,
            "metrics_series": series,
            "best_epoch": events.metadata.best_epoch(),
            "resource_usage": usage.snapshot(),
            "code_version": CodeVersion().snapshot(),
            "directory": directory}
