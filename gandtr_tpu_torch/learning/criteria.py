"""Training criteria (counterpart of gandtr_tpu/learning/criteria.py; the
reference's optim/criterion registry).

- the base losses `l1`, `mse`, `bce` (its target detached,
  base_losses.py:22-23) and `bce_with_logits` (a float `pos_weight`), each
  with torch's `reduction` (mean by default);
- the fine-tune's tuple losses over (D, N) column descriptors, sum
  reduced: `contrastive`, `triplet`, and `contrastive_multidesc`, which
  weighs a list of descriptor matrices (cirlosses.py:22-45) and returns
  a `TotalWithIntermediate` (mdir/tools/loss_value.py);
- the compound `multihead_loss` (compound_losses.py:67-97), a weighted
  sum of member losses each on its own key of dict outputs and targets,
  and `combination_loss` (:100-109), the same on one output and target;
  each returns a `TotalWithIntermediate` with the weighted parts;
- `check_criterion_losses`: a GAN config asks only for the losses its
  family's step computes (the JAX package's build.py:44-73). The GAN steps
  read their weights from the config themselves and compute their own
  multihead_loss.

The registry's other compound entries (cycle_loss, discriminator_loss,
loss_set, multilayer_patchnce_loss) are what the GAN steps compute
inside; as stand-alone criteria they raise by name.
"""
import dataclasses

import torch

from gandtr_tpu_torch.ops import losses as L


class Zero:
    """The algebraic identity of loss values (loss_value.py:9-27): the
    first addition replaces it with the other operand."""

    def __add__(self, obj):
        return obj

    __radd__ = __add__

    def __sub__(self, obj):
        return -obj

    def __mul__(self, obj):
        return self

    def __truediv__(self, obj):
        return self


ZERO = Zero()


class TotalWithIntermediate:
    """A total and its named parts (loss_value.py:36-117): nested parts
    flatten to "<key>.<sub>" keys, the nested total kept under the key;
    + and - of two values act part by part (the keys must match), * and /
    by a scalar scale the parts too, and + or - of a plain value acts on
    the total alone."""

    def __init__(self, total, **partial):
        self.total = total
        self.partial = self._flatten(partial)

    @classmethod
    def from_partial(cls, **partial):
        flat = cls._flatten(partial)
        total = ZERO
        for v in flat.values():
            total = total + v
        return cls(total, **flat)

    @staticmethod
    def _flatten(partial):
        flat = {}
        for key, value in partial.items():
            if isinstance(value, TotalWithIntermediate):
                for sub, v in value.partial.items():
                    flat["%s.%s" % (key, sub)] = v
                value = value.total
            flat[key] = value
        return flat

    def _merge(self, other, op):
        if self.partial.keys() != other.partial.keys():
            raise ValueError("loss parts differ: %s vs %s"
                             % (sorted(self.partial), sorted(other.partial)))
        return TotalWithIntermediate(
            op(self.total, other.total),
            **{k: op(v, other.partial[k]) for k, v in self.partial.items()})

    def __add__(self, other):
        if isinstance(other, TotalWithIntermediate):
            return self._merge(other, lambda a, b: a + b)
        if isinstance(other, Zero):
            return self
        return self.total + other

    def __radd__(self, other):
        if isinstance(other, Zero):
            return self
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, TotalWithIntermediate):
            return self._merge(other, lambda a, b: a - b)
        return self.total - other

    def __mul__(self, other):
        return TotalWithIntermediate(
            self.total * other,
            **{k: v * other for k, v in self.partial.items()})

    __rmul__ = __mul__

    def __truediv__(self, other):
        return TotalWithIntermediate(
            self.total / other,
            **{k: v / other for k, v in self.partial.items()})

    def __float__(self):
        return float(self.total)


def _reduce(d, reduction):
    if reduction == "mean":
        return d.mean()
    if reduction == "sum":
        return d.sum()
    if reduction == "none":
        return d
    raise ValueError("unknown reduction %r" % (reduction,))


@dataclasses.dataclass
class L1Loss:
    reduction: str = "mean"

    def __call__(self, x, target):
        # torch's subgradient at a tie is 0 (ops/losses.py::l1_loss)
        return _reduce(torch.abs(x - target), self.reduction)


@dataclasses.dataclass
class MSELoss:
    reduction: str = "mean"

    def __call__(self, x, target):
        return _reduce((x - target) ** 2, self.reduction)


@dataclasses.dataclass
class BCELoss:
    """Binary cross entropy of probabilities; the target takes no
    gradient (base_losses.py:22-23)."""
    reduction: str = "mean"

    def __call__(self, p, target):
        target = target.detach()
        p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
        d = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
        return _reduce(d, self.reduction)


@dataclasses.dataclass
class BCEWithLogitsLoss:
    pos_weight: float = None
    reduction: str = "mean"

    def __call__(self, logits, target):
        log_p = torch.nn.functional.logsigmoid(logits)
        log_not_p = torch.nn.functional.logsigmoid(-logits)
        w = 1.0 if self.pos_weight is None else float(self.pos_weight)
        d = -(w * target * log_p + (1.0 - target) * log_not_p)
        return _reduce(d, self.reduction)


def _concat_label(label):
    if isinstance(label, (list, tuple)):
        label = torch.cat([torch.as_tensor(l) for l in label])
    return label


@dataclasses.dataclass
class ContrastiveLoss:
    """Sum-reduced contrastive over (D, N) column descriptors. The
    deprecated `eps` parameter is accepted and ignored (cirlosses.py:12-15,
    as in the JAX package)."""
    margin: float = 0.7
    eps: float = None
    reduction: str = "sum"

    def __call__(self, x, label, num_tuples=1):
        return L.contrastive_loss(x, _concat_label(label), num_tuples,
                                  margin=self.margin)


@dataclasses.dataclass
class ContrastiveLossMultipleDescriptors(ContrastiveLoss):
    """The contrastive loss of each matrix of a list of (D, N) descriptor
    matrices, weighted (`weights` a list or "w1,w2,..."; equal weights
    summing to 1 when None) and summed: a TotalWithIntermediate with each
    matrix's loss under its index. A single matrix is the contrastive
    loss."""
    weights: object = None

    def __call__(self, x, label, num_tuples=1):
        if not isinstance(x, list):
            return super().__call__(x, label, num_tuples)
        weights = self.weights
        if isinstance(weights, str):
            weights = [float(w) for w in weights.split(",")]
        if weights is None:
            weights = [1.0 / len(x)] * len(x)
        if len(weights) != len(x):
            raise ValueError("%d weights for %d descriptor matrices"
                             % (len(weights), len(x)))
        partial, total = {}, ZERO
        for i, xi in enumerate(x):
            loss = super().__call__(xi, label, num_tuples)
            partial[str(i)] = loss
            total = total + weights[i] * loss
        return TotalWithIntermediate(total, **partial)


@dataclasses.dataclass
class TripletLoss:
    margin: float = 0.1
    reduction: str = "sum"

    def __call__(self, x, label, num_tuples=1):
        return L.triplet_loss(x, _concat_label(label), num_tuples,
                              margin=self.margin)


class MultiheadLoss:
    """Weighted dict-keyed loss over multi-head outputs
    (compound_losses.py:67-97): `weights` a number for every member or a
    dict by member, divided by their sum with `normalize_weights`; the
    reduction is the members' own when they share one, else "mixed"."""

    def __init__(self, weights, normalize_weights=False, **losses):
        self.losses = {k: initialize_criterion(dict(v))
                       for k, v in losses.items()}
        if isinstance(weights, (int, float)):
            weights = {key: weights for key in self.losses}
        weights = dict(weights)
        if normalize_weights:
            total = sum(weights.values())
            weights = {k: v / total for k, v in weights.items()}
        if self.losses.keys() != weights.keys():
            raise ValueError("loss keys %s differ from weight keys %s"
                             % (sorted(self.losses), sorted(weights)))
        self.weights = weights
        reductions = [getattr(x, "reduction", "mean")
                      for x in self.losses.values()]
        self.reduction = (reductions[0] if len(set(reductions)) == 1
                          else "mixed")

    def _term(self, key, output, target):
        return self.losses[key](output[key], target[key])

    def __call__(self, output, target):
        total, partial = ZERO, {}
        for key in self.losses:
            partial[key] = self.weights[key] * self._term(key, output,
                                                          target)
            total = total + partial[key]
        return TotalWithIntermediate(total, **partial)


class CombinationLoss(MultiheadLoss):
    """The weighted sum of several losses on the same output and target
    (compound_losses.py:100-109)."""

    def _term(self, key, output, target):
        return self.losses[key](output, target)


CRITERIA = {"l1": L1Loss, "mse": MSELoss, "bce": BCELoss,
            "bce_with_logits": BCEWithLogitsLoss,
            "contrastive": ContrastiveLoss,
            "contrastive_multidesc": ContrastiveLossMultipleDescriptors,
            "triplet": TripletLoss, "multihead_loss": MultiheadLoss,
            "combination_loss": CombinationLoss}
#: the JAX registry's other compound entries: the GAN steps compute them
#: inside
COMPUTED_BY_STEPS = ("cycle_loss", "discriminator_loss", "loss_set",
                     "multilayer_patchnce_loss")


def initialize_criterion(params):
    """{loss: name, ...kwargs} -> a criterion, or None for an empty
    config."""
    if not params:
        return None
    params = dict(params)
    name = params.pop("loss")
    if name in COMPUTED_BY_STEPS:
        raise NotImplementedError(
            "criterion %r is computed inside the GAN steps of this package "
            "and has no stand-alone form" % name)
    if name not in CRITERIA:
        raise KeyError("unknown criterion %r" % name)
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
