"""Training criteria (counterpart of gandtr_tpu/learning/criteria.py).
Ported so far: the contrastive loss of the GeM fine-tune."""
import dataclasses

import torch

from gandtr_tpu_torch.ops import losses as L


@dataclasses.dataclass
class ContrastiveLoss:
    """Sum-reduced contrastive over (D, N) column descriptors. The
    deprecated `eps` parameter is accepted and ignored (cirlosses.py:12-15,
    as in the JAX package)."""
    margin: float = 0.7
    eps: float = None
    reduction: str = "sum"

    def __call__(self, x, label, num_tuples=1):
        if isinstance(label, (list, tuple)):
            label = torch.cat([torch.as_tensor(l) for l in label])
        return L.contrastive_loss(x, label, num_tuples, margin=self.margin)


CRITERIA = {"contrastive": ContrastiveLoss}


def initialize_criterion(params):
    """{loss: name, ...kwargs} -> a criterion, or None for an empty config."""
    if not params:
        return None
    params = dict(params)
    name = params.pop("loss")
    if name not in CRITERIA:
        raise NotImplementedError("criterion %r is not ported yet" % name)
    return CRITERIA[name](**params)
