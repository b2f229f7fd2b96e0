"""The network loader of the scenario stages (counterpart of
gandtr_tpu/scenarios/infer_stage.py::_load_network). The infer stage
itself is not ported yet."""
import torch

from gandtr_tpu_torch.hub import (_checkpoint_data_params,
                                  _checkpoint_model_state,
                                  _checkpoint_net_state, _init_random)
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.utils.io import resolve_path


def _load_network(net_cfg, device):
    """A WrappedNet on `device` from a SingleNetwork section: the built net
    with seeded weights (`path: null`), or a reference `.pth` checkpoint.

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
        if not path.endswith((".pth", ".pt")) or "://" in path:
            raise NotImplementedError(
                "network checkpoint %r: only a local reference .pth loads; "
                "the JAX package's own checkpoint files "
                "(learning/checkpoints.py) are not ported yet (ROADMAP A.2)"
                % path)
        net_state = _checkpoint_net_state(
            torch.load(path, map_location="cpu", weights_only=False))
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
