"""Model container (counterpart of gandtr_tpu/learning/network.py): a
module with its train and eval wrapper chains, metadata and runtime
settings. Unlike the JAX container, the weights live in the `nn.Module`.

`compute_dtype` (e.g. torch.bfloat16) is mixed precision, in two forms:

- Training (`apply(..., train=True)` while autograd records): the float
  parameters are cast inside the forward (`torch.func.functional_call` with
  `p.to(dtype)`), so the cast is part of the graph, gradients land on the
  float32 master parameters and the optimizer's state stays float32, as
  in the JAX package.
- Inference: `compute_module()` is a copy of the module with its float
  parameters cast, made once and remade only when a parameter changes, so
  a served forward casts nothing per call. It takes no gradient.

Buffers (BatchNorm's running statistics) stay float32 in both, as in the
JAX package, and a float input is cast likewise.

`build_network_set` is the NetworkSet of the GAN configs (network.py:
167-253): named WrappedNets, each with its `runtime.frozen`, and the
`initialize` spec of each. A member given by `path:` (a warm start) is
rewritten before, by scenarios/build.py::adopt_path_members. A
`MultiheadNetwork` member is a WrappedNet around a `MultiheadModule`
(`build_multihead_net`); a `SingleNetworkLink` member is its target's
WrappedNet under a second name, so it shares the target's weights as the
reference's link does (the JAX ModelSet gives a link variables of its
own).

`MultiheadModule` (the reference's MultiheadNetwork, network.py:756-879)
is base -> optional split -> heads; `GlobalLocalModule` (its
GlobalLocalNetwork, network.py:374-517) pools a global descriptor and
makes the multi-scale local features of the grouping layers
(models/grouping.py).
"""
import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch
from torch import nn

from gandtr_tpu_torch.learning.wrappers import CirMultiscaleAggregation, \
    apply_wrapped, initialize_wrappers
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.extra_layers import l2norm_attention
from gandtr_tpu_torch.models.layers import tensor_key
from gandtr_tpu_torch.ops.maskprop import MaskState
from gandtr_tpu_torch.ops.norm import l2n
from gandtr_tpu_torch.ops.pooling import gem
from gandtr_tpu_torch.ops.resize import scale_resize
from gandtr_tpu_torch.parallel import spatial

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


@dataclass
class WrappedNet:
    module: nn.Module
    wrappers_eval: List[Any] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    data_params: Dict[str, Any] = field(default_factory=dict)
    compute_dtype: Any = None
    wrappers_train: List[Any] = field(default_factory=list)
    frozen: bool = False
    _cast: Any = field(default=None, init=False, repr=False)

    def compute_module(self):
        """The module in `compute_dtype` for inference: the module itself
        without one, else its cached cast copy."""
        if self.compute_dtype is None:
            return self.module
        key = (self.compute_dtype,
               tuple(map(tensor_key, self.module.parameters())))
        if self._cast is None or self._cast[0] != key:
            # outside inference mode: the copy's tensors must keep version
            # counters, which key the caches made from them
            with torch.inference_mode(False), torch.no_grad():
                module = copy.deepcopy(self.module)
                for p in module.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(self.compute_dtype)
            self._cast = (key, module)
        return self._cast[1]

    def _forward_fn(self, train):
        """The module's forward in `compute_dtype`: a differentiable cast
        when autograd records a training forward, else the cached copy."""
        mode = train and not self.frozen
        if self.compute_dtype is None:
            self.module.train(mode)
            return self.module
        if train and torch.is_grad_enabled():
            self.module.train(mode)
            dt = self.compute_dtype
            params = {name: (p.to(dt) if p.is_floating_point() else p)
                      for name, p in self.module.named_parameters()}

            def forward(*args, **kw):
                return torch.func.functional_call(self.module, params, args,
                                                  kw)
            return forward
        module = self.compute_module()
        module.train(mode)
        return module

    def apply(self, x, ctx=None, train=False, model_positions=None,
              mask=None, host_hw=None, **kwargs):
        """The forward inside the train or eval wrapper chain. x: (N, H, W,
        3) (or a (T, S, H, W, 3) tuple batch for `cirfaketuplebatch`).

        `model_positions` (a tuple of batch rows) runs the module on those
        rows only and passes the others through; the wrappers still see the
        whole batch. `mask` (N, H, W) is the padded-bucket mode: the module
        gets it, mask-aware wrappers follow the valid rectangle through
        `ctx["mask_state"]`, and a module that transforms images (returns
        `(y, out_mask)`) makes `apply` return `(y, out_mask)` too.
        `host_hw`, the rows' (h, w) on the host where the caller padded
        them, is what a multiscale wrapper resizes each row by (it is
        required there with a mask). Under a multiscale wrapper each scale
        runs the module with its own mask. Other keyword arguments go to
        the module's forward (HED's `no_sigmoid`)."""
        wrappers = self.wrappers_train if train else self.wrappers_eval
        if model_positions is not None and len(model_positions) == 0 and \
                any(isinstance(w, CirMultiscaleAggregation) for w in wrappers):
            # the JAX package passes each scale through unchanged here and
            # drops the scale's mask (its network.py:112); refuse instead
            raise ValueError("model_positions=() under a multiscale wrapper "
                             "would pass every scale through unchanged")
        forward_fn = self._forward_fn(train)
        ctx = dict(ctx or {})
        if mask is not None:
            ctx["mask_state"] = ctx["mask_state_in"] = MaskState.maybe(
                mask, host_hw)
        if self.compute_dtype is not None and x.is_floating_point():
            x = x.to(self.compute_dtype)
        through = [None]

        def run_module(xx, row_mask):
            out = (forward_fn(xx, **kwargs) if row_mask is None
                   else forward_fn(xx, mask=row_mask, **kwargs))
            if row_mask is not None and isinstance(out, tuple):
                out, through[0] = out
            return out

        def forward(xx):
            row_mask = mask
            if mask is not None and isinstance(xx, tuple):
                xx, row_mask = xx      # a multiscale (x, mask) pair
            if model_positions is None:
                out = run_module(xx, row_mask)
            elif len(model_positions) == 0:
                out = xx
            else:
                # row slices, not an index tensor: nothing goes to the device
                rows = [slice(p, p + 1) for p in model_positions]
                sel = run_module(
                    torch.cat([xx[r] for r in rows]),
                    None if row_mask is None else torch.cat([row_mask[r]
                                                             for r in rows]))
                out = xx.clone()
                for j, r in enumerate(rows):
                    out[r] = sel[j:j + 1].to(xx.dtype)
                if through[0] is not None:
                    full = mask.clone()
                    for j, r in enumerate(rows):
                        full[r] = through[0][j:j + 1].to(full.dtype)
                    through[0] = full
            if through[0] is not None:
                ctx["mask_state"] = MaskState.maybe(through[0])
            return out

        y = apply_wrapped(wrappers, forward, x, ctx)
        if mask is not None and through[0] is not None:
            y = (y, ctx["mask_state"].mask(y.shape[1], y.shape[2],
                                           torch.float32))
        return y


def build_single_net(config, device="cpu"):
    """A WrappedNet from a reference-style SingleNetwork config ({model:
    {...}, runtime: {wrappers, data, frozen, dtype}}), its module on
    `device` with the module's own initial weights (the caller seeds or
    loads them). `pretrained` is dropped: checkpoints load outside."""
    config = dict(config)
    model_params = dict(config.get("model", {}))
    model_params.pop("pretrained", None)
    module = initialize_model(model_params).to(device)
    runtime = dict(config.get("runtime", {}) or {})
    wrappers = runtime.get("wrappers", "")
    if isinstance(wrappers, dict):     # {"train": ..., "eval": ...}
        train_w = initialize_wrappers(wrappers.get("train"))
        eval_w = initialize_wrappers(wrappers.get("eval"))
    else:
        train_w = eval_w = initialize_wrappers(wrappers)
    dtype = runtime.get("dtype") or config.get("dtype")
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    return WrappedNet(module=module, wrappers_eval=eval_w,
                      wrappers_train=train_w,
                      frozen=bool(runtime.get("frozen", False)),
                      meta=dict(getattr(module, "meta", {}) or {}),
                      data_params=runtime.get("data", {}) or {},
                      compute_dtype=dtype)


class MultiheadModule(nn.Module):
    """A shared base feeding heads (the reference's MultiheadNetwork,
    network.py:756-879): an optional `split` WrappedNet turns the base's
    output into one piece per head (a list or tuple, in head order), or,
    with no split, every head takes the base's output. `base`, `split` and
    the heads are WrappedNets (their wrappers and compute dtypes apply);
    their modules are this module's children `base`, `split` and
    `<head>`, so the state_dict keys are `base.*`, `split.*`, `<head>.*`.

    `forward(x, head=None)`: the output of `head` (a head's name or
    "base"), else of `default_output`, else the dict of "base" and every
    head (network.py:818-839). The subnets run in this module's train
    mode. `parameter_groups` maps "base", "split" or a head to its
    optimizer multipliers {"lr": m, "weight_decay": m}
    (learning/optimizers.py::multihead_mults)."""

    def __init__(self, base, heads, default_output=None, split=None,
                 parameter_groups=None):
        super().__init__()
        if default_output not in (None, "base") and \
                default_output not in heads:
            raise ValueError("default_output %r is neither base nor a head"
                             % (default_output,))
        if {"base", "split"} & set(heads):
            raise ValueError("a head may not be named base or split")
        self.nets = dict(base=base, **({"split": split} if split else {}),
                         **heads)
        for name, net in self.nets.items():
            self.add_module(name, net.module)
        self.head_names = tuple(heads)
        self.default_output = default_output
        self.parameter_groups = dict(parameter_groups or {})

    def _pieces(self, h):
        """Each head's input (network.py:826-828)."""
        if "split" not in self.nets:
            return {name: h for name in self.head_names}
        pieces = self.nets["split"].apply(h, train=self.training)
        if not isinstance(pieces, (list, tuple)) or \
                len(pieces) != len(self.head_names):
            # the JAX package zips whatever the split returns, so a single
            # tensor is cut along its batch axis (ROADMAP, reference faults)
            raise ValueError(
                "the split must return one piece per head (%d), got %s"
                % (len(self.head_names), type(pieces).__name__
                   if not isinstance(pieces, (list, tuple))
                   else "%d pieces" % len(pieces)))
        return dict(zip(self.head_names, pieces))

    def forward(self, x, head=None, **kwargs):
        h = self.nets["base"].apply(x, train=self.training, **kwargs)
        single = head if head is not None else self.default_output
        if single == "base":
            return h
        pieces = self._pieces(h)
        if single is not None:
            return self.nets[single].apply(pieces[single],
                                           train=self.training)
        out = {"base": h}
        out.update({name: self.nets[name].apply(pieces[name],
                                                train=self.training)
                    for name in self.head_names})
        return out


def build_multihead_net(config, device="cpu"):
    """A WrappedNet around the MultiheadModule of a reference-style
    MultiheadNetwork config ({type: MultiheadNetwork, network_order:
    "base,split,head,...", runtime: {default_output, data},
    parameter_groups: {...}, <name>: SingleNetwork config}), as the JAX
    package's build_multihead_net (network.py:841-846): network_order names
    the base, the split, then the heads; default_output is not the split;
    the groups of the base and the split are renamed `base` and `split`;
    `data_params` come from `runtime.data`, else the base's."""
    config = dict(config)
    config.pop("type", None)
    order = [s.strip() for s in config.pop("network_order").split(",")]
    runtime = dict(config.pop("runtime", {}) or {})
    groups = dict(config.pop("parameter_groups", {}) or {})
    if len(order) < 3:
        raise ValueError("network_order %r names no head" % (order,))
    base_name, split_name, *head_names = order
    default_output = runtime.get("default_output")
    if default_output not in order or default_output == split_name:
        raise ValueError("default_output %r must be the base or a head of %r"
                         % (default_output, order))
    subs = {name: build_single_net(config[name], device=device)
            for name in order}
    rename = {base_name: "base", split_name: "split"}
    module = MultiheadModule(
        subs[base_name], {name: subs[name] for name in head_names},
        default_output=rename.get(default_output, default_output),
        split=subs[split_name],
        parameter_groups={rename.get(k, k): v for k, v in groups.items()})
    return WrappedNet(module=module, data_params=dict(
        runtime.get("data") or subs[base_name].data_params or {}))


class GlobalLocalModule:
    """Global and local descriptors of one features net (the reference's
    GlobalLocalNetwork, network.py:374-517): `features` is a WrappedNet
    whose forward maps (N, H, W, 3) images to (N, h, w, C) feature maps,
    channels last as everywhere in the port (the JAX package's NHWC).
    `forward_global(x)` = l2n(pool_fn(features(x))), GeM with p 3 by
    default; `forward_local(x)` returns, for each of `scales` (SCALES by
    default, network.py:374-377), the (features (N, h, w, C), attention
    (N, h, w, 1)) of the image resized by that scale (`scale_resize`), the
    attention `l2norm_attention` by default. The weights are the features
    net's."""

    SCALES = (1.0, 0.7071, 0.5, 0.3536, 0.25)

    def __init__(self, features, pool_fn=None, attention_fn=None,
                 scales=None):
        self.features = features
        self.pool_fn = pool_fn or gem
        self.attention_fn = attention_fn or l2norm_attention
        self.scales = tuple(scales) if scales else self.SCALES

    def forward_global(self, x):
        spatial.refuse("GlobalLocalModule")
        return l2n(self.pool_fn(self.features.apply(x)))

    def forward_local(self, x):
        spatial.refuse("GlobalLocalModule")
        out = []
        for s in self.scales:
            f = self.features.apply(scale_resize(x, s) if s != 1.0 else x)
            out.append((f, self.attention_fn(f)))
        return out


def build_network_set(config, device="cpu"):
    """({name: WrappedNet}, {name: initialize spec}) from a NetworkSet
    config ({type: NetworkSet, <name>: member config, ...}); each module on
    `device` with its own initial weights (the caller seeds or loads
    them). A member is a SingleNetwork, a MultiheadNetwork
    (`build_multihead_net`) or a SingleNetworkLink (`link` or `network`
    names its target): the target's WrappedNet itself, placed after the
    other members as in the JAX package. A member set to null is left
    out."""
    config = dict(config)
    if config.pop("type", "NetworkSet") != "NetworkSet":
        raise ValueError("not a NetworkSet config")
    nets, init_specs, links = {}, {}, {}
    for name, sub in config.items():
        if sub is None:
            continue
        sub = dict(sub)
        kind = sub.pop("type", "SingleNetwork")
        if kind == "SingleNetworkLink":
            links[name] = sub.get("link") or sub.get("network")
            continue
        if kind not in ("SingleNetwork", "MultiheadNetwork"):
            raise NotImplementedError("NetworkSet member %s of type %s"
                                      % (name, kind))
        if sub.get("path"):
            raise ValueError("NetworkSet member %s: a `path` member is "
                             "adopted before the set is built "
                             "(scenarios/build.py::adopt_path_members)"
                             % name)
        sub.pop("path", None)
        spec = sub.pop("initialize", None)
        nets[name] = (build_multihead_net(sub, device=device)
                      if kind == "MultiheadNetwork"
                      else build_single_net(sub, device=device))
        if spec:
            init_specs[name] = dict(spec)
    for name, target in links.items():
        if target not in nets:
            raise KeyError("NetworkSet link %s names no member %r"
                           % (name, target))
        nets[name] = nets[target]
    return nets, init_specs

