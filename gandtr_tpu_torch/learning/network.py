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
"""
import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch
from torch import nn

from gandtr_tpu_torch.learning.wrappers import CirMultiscaleAggregation, \
    apply_wrapped, initialize_wrappers
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.layers import tensor_key
from gandtr_tpu_torch.ops.maskprop import MaskState

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
              mask=None):
        """The forward inside the train or eval wrapper chain. x: (N, H, W,
        3) (or a (T, S, H, W, 3) tuple batch for `cirfaketuplebatch`).

        `model_positions` (a tuple of batch rows) runs the module on those
        rows only and passes the others through; the wrappers still see the
        whole batch. `mask` (N, H, W) is the padded-bucket mode: the module
        gets it, mask-aware wrappers follow the valid rectangle through
        `ctx["mask_state"]`, and a module that transforms images (returns
        `(y, out_mask)`) makes `apply` return `(y, out_mask)` too."""
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
            ctx["mask_state"] = ctx["mask_state_in"] = MaskState.maybe(mask)
        if self.compute_dtype is not None and x.is_floating_point():
            x = x.to(self.compute_dtype)
        through = [None]

        def run_module(xx, row_mask):
            out = (forward_fn(xx) if row_mask is None
                   else forward_fn(xx, mask=row_mask))
            if row_mask is not None and isinstance(out, tuple):
                out, through[0] = out
            return out

        def forward(xx):
            if model_positions is None:
                out = run_module(xx, mask)
            elif len(model_positions) == 0:
                out = xx
            else:
                # row slices, not an index tensor: nothing goes to the device
                rows = [slice(p, p + 1) for p in model_positions]
                sel = run_module(
                    torch.cat([xx[r] for r in rows]),
                    None if mask is None else torch.cat([mask[r]
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
    wrappers = initialize_wrappers(runtime.get("wrappers", ""))
    dtype = runtime.get("dtype") or config.get("dtype")
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    return WrappedNet(module=module, wrappers_eval=wrappers,
                      wrappers_train=wrappers,
                      frozen=bool(runtime.get("frozen", False)),
                      meta=dict(getattr(module, "meta", {}) or {}),
                      data_params=runtime.get("data", {}) or {},
                      compute_dtype=dtype)
