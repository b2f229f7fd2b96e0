"""Model container (counterpart of gandtr_tpu/learning/network.py): a
module with its eval wrapper chain and metadata.

Unlike the JAX container, the weights live in the `nn.Module` itself. Only
the eval forward without a mask and without `model_positions` is ported;
the train chain comes with the fine-tune step.

`compute_dtype` (e.g. torch.bfloat16) is mixed precision for inference:
`apply` runs a copy of the module whose float parameters are cast to it,
made once and remade only when a parameter changes, and casts a float
input likewise. Buffers (BatchNorm's running statistics) stay float32, as
in the JAX package.
"""
import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch
from torch import nn

from gandtr_tpu_torch.learning.wrappers import apply_wrapped
from gandtr_tpu_torch.models.layers import tensor_key


@dataclass
class WrappedNet:
    module: nn.Module
    wrappers_eval: List[Any] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    data_params: Dict[str, Any] = field(default_factory=dict)
    compute_dtype: Any = None
    _cast: Any = field(default=None, init=False, repr=False)

    def compute_module(self):
        """The module in `compute_dtype`: the module itself without one,
        else its cached cast copy."""
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

    def apply(self, x, ctx=None):
        """The eval forward inside the eval wrapper chain. x: (N, H, W, 3)."""
        module = self.compute_module()
        module.eval()
        if self.compute_dtype is not None and x.is_floating_point():
            x = x.to(self.compute_dtype)
        return apply_wrapped(self.wrappers_eval, module, x, ctx)
