"""Training criteria (counterpart of gandtr_tpu/learning/criteria.py).
Ported so far: the contrastive loss of the GeM fine-tune, and the check
that a GAN config asks only for the losses its family's step computes
(the JAX package's build.py:44-73)."""
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


#: the loss names each GAN family's step implements: the reference's mse
#: adversarial and l1 terms of every published config
FAMILY_LOSSES = {
    "cyclegan": {"cycle_loss", "multihead_loss", "discriminator_loss",
                 "mse", "l1"},
    "cut": {"multihead_loss", "discriminator_loss",
            "multilayer_patchnce_loss", "mse", "l1"},
    "hedgan": {"multihead_loss", "discriminator_loss", "mse", "l1"},
    "hedngan": {"multihead_loss", "discriminator_loss", "mse", "l1"},
}


def check_criterion_losses(criterion, family):
    """Refuse a `loss:` anywhere in the criterion tree that the family's
    step does not compute: a different base loss must fail, not train with
    the step's own."""
    allowed = FAMILY_LOSSES[family]

    def walk(node):
        if not isinstance(node, dict):
            return
        for key, value in node.items():
            if key == "loss" and isinstance(value, str) \
                    and value not in allowed:
                raise NotImplementedError(
                    "criterion loss %r is not implemented by the %s step "
                    "(supported: %s)" % (value, family, sorted(allowed)))
            walk(value)

    walk(criterion)
