"""Model container (counterpart of gandtr_tpu/learning/network.py): a
module with its eval wrapper chain and metadata.

Unlike the JAX container, the weights live in the `nn.Module` itself. Only
the eval forward without a mask and without `model_positions` is ported;
the train chain comes with the fine-tune step.
"""
from dataclasses import dataclass, field
from typing import Any, Dict, List

from torch import nn

from gandtr_tpu_torch.learning.wrappers import apply_wrapped


@dataclass
class WrappedNet:
    module: nn.Module
    wrappers_eval: List[Any] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    data_params: Dict[str, Any] = field(default_factory=dict)

    def apply(self, x, ctx=None):
        """The eval forward inside the eval wrapper chain. x: (N, H, W, 3)."""
        self.module.eval()
        return apply_wrapped(self.wrappers_eval, self.module, x, ctx)
