"""Optimizers with the reference's semantics (counterpart of
gandtr_tpu/learning/optimizers.py; the reference's base_optimizers.py).

The reference trains with torch's own `Adam`, whose weight decay is L2
added to the gradient (not AdamW's decoupled decay); the JAX package
rebuilds that as an optax chain. Here it is torch's optimizer itself.

Parameter groups follow the reference's `parameter_groups`:

- cirnet, cirnet_inchan, cirnet_attention and gem_retrieval (cirnet.py:
  11-33, 79-82, 127-131; the JAX package's `_cirnet_leaf_mults`): the GeM
  `p` (`pool.p`, or `pool.rpool.p` of a regional net) at lr x10 and
  weight decay 0, the edge filter's `preprocessing.*` at lr x10, an
  `attention.*` module at lr x100, everything else x1;
- hed_interpolation (hed.py:86-112, `_hed_leaf_mults`): lr x1 for the VGG
  weights and x2 for their biases, x100 / x200 in block 5, x0.01 / x0.02
  for the score heads and x0.001 / x0.002 for the fusion; weight decay on
  the weights only.

A multi-head net (learning/network.py::MultiheadModule) takes its
config-level `parameter_groups` instead (network.py:764, 482-496; the JAX
package's `multihead_group_mults`): every parameter of subnet `base`,
`split` or `<head>` at lr x `parameter_groups[subnet]["lr"]` and weight
decay x `["weight_decay"]`, 1.0 for a subnet or key not named.

Each group keeps its `lr_mult`, so a schedule sets lr = base_lr * lr_mult
* factor (`set_learning_rate`). Weight decay is torch's own: L2 added to
the gradient, as the JAX package's `_decay_per_leaf` adds it before the
moments. SGD is torch's with `momentum`, dampening 0 and no Nesterov:
decay, then the momentum trace, then the learning rate, the order of the
JAX package's optax chain.

`AlternationGate` is the reference's OptimizerAlternation round robin
(`composition.alternate_iteration` other than 1): member `i` of `order`
steps only while `alternation_active(t, i, len(order), n)` holds for the
0-based training step t.
"""
import torch


def _cirnet_mults(name):
    parts = name.split(".")
    if parts[-1] == "p" and "pool" in parts:
        return 10.0, 0.0
    if parts[0] == "preprocessing":
        return 10.0, 1.0
    if parts[0] == "attention":
        return 100.0, 1.0
    return 1.0, 1.0


def _hed_mults(name):
    top = name.split(".", 1)[0]
    weight = not name.endswith(".bias")
    if top == "vgg5":
        return (100.0, 1.0) if weight else (200.0, 0.0)
    if top.startswith("vgg"):
        return (1.0, 1.0) if weight else (2.0, 0.0)
    if top.startswith("score"):
        return (0.01, 1.0) if weight else (0.02, 0.0)
    if top == "fusion":
        return (0.001, 1.0) if weight else (0.002, 0.0)
    raise KeyError("HED parameter not recognized %r (hed.py:96)" % name)


GROUP_MULTS = {"cirnet": _cirnet_mults, "cirnet_inchan": _cirnet_mults,
               "cirnet_attention": _cirnet_mults,
               "gem_retrieval": _cirnet_mults,
               "hed_interpolation": _hed_mults}


def multihead_mults(parameter_groups):
    """The (lr_mult, wd_mult) of a multi-head net's parameter by its name
    (`<subnet>.<...>`), from the net's `parameter_groups`."""
    def mults(name):
        group = parameter_groups.get(name.split(".", 1)[0]) or {}
        return (float(group.get("lr", 1.0)),
                float(group.get("weight_decay", 1.0)))
    return mults


def param_groups(architecture, named_parameters, parameter_groups=None):
    """[(lr_mult, wd_mult, [params])] for `architecture`: its table in
    GROUP_MULTS, or one group for an architecture the reference gives no
    groups (the GAN generators and discriminators); by subnet for a
    multi-head net's `parameter_groups`."""
    groups = {}
    mults = (multihead_mults(parameter_groups)
             if parameter_groups is not None
             else GROUP_MULTS.get(architecture))
    for name, p in named_parameters:
        if not p.requires_grad:
            continue
        key = mults(name) if mults else (1.0, 1.0)
        groups.setdefault(key, []).append(p)
    return [(lr, wd, ps) for (lr, wd), ps in groups.items()]


def initialize_optimizer(params, named_parameters, architecture="",
                         parameter_groups=None):
    """A torch optimizer from a reference-style config: {algorithm: adam,
    lr, beta1, beta2, weight_decay} or {algorithm: sgd, lr, momentum,
    weight_decay}, its groups by `param_groups`. Returns (optimizer,
    base_lr)."""
    params = dict(params)
    algorithm = params.pop("algorithm")
    if algorithm not in ("adam", "sgd"):
        raise NotImplementedError("optimizer %r is not ported yet" % algorithm)
    lr = float(params.pop("lr"))
    wd = float(params.pop("weight_decay", 0.0))
    groups = [{"params": ps, "lr": lr * lr_mult, "weight_decay": wd * wd_mult,
               "lr_mult": lr_mult}
              for lr_mult, wd_mult, ps in param_groups(
                  architecture, named_parameters, parameter_groups)]
    if algorithm == "sgd":
        return torch.optim.SGD(groups, lr=lr,
                               momentum=float(params.pop("momentum", 0.0)),
                               dampening=0.0, nesterov=False,
                               weight_decay=wd), lr
    opt = torch.optim.Adam(groups, lr=lr,
                           betas=(float(params.pop("beta1", 0.9)),
                                  float(params.pop("beta2", 0.999))),
                           eps=1e-8, weight_decay=wd)
    return opt, lr


def set_learning_rate(optimizer, base_lr, factor=1.0):
    """Each group's lr = base_lr * its lr_mult * the schedule's factor."""
    for group in optimizer.param_groups:
        group["lr"] = base_lr * group.get("lr_mult", 1.0) * factor


def alternation_active(t, index, n_optimizers, alternate_iteration):
    """Whether member `index` steps at the 0-based training step `t`: the
    reference's OptimizerAlternation advances every |n| calls, so the
    active member is (t // |n|) % K (a negative n rotates like |n|, as
    the reference's modulo does); n of 0 or None keeps every member
    active."""
    n = alternate_iteration
    if n in (None, 0):
        return True
    return (int(t) // abs(int(n))) % n_optimizers == index


class AlternationGate:
    """Member `index` of an optimizer rotation around a torch optimizer:
    `step()` counts the training step and steps the optimizer only while
    the member is active, so an inactive member's parameters and state
    (Adam's step count too) stay as they are. The count is saved with the
    optimizer's state, so a resumed run keeps the rotation's phase."""

    def __init__(self, optimizer, index, n_optimizers, alternate_iteration):
        self.optimizer = optimizer
        self.index = int(index)
        self.n_optimizers = int(n_optimizers)
        self.alternate_iteration = alternate_iteration
        self.count = 0

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def active(self):
        return alternation_active(self.count, self.index, self.n_optimizers,
                                  self.alternate_iteration)

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self):
        if self.active():
            self.optimizer.step()
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "inner": self.optimizer.state_dict()}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.optimizer.load_state_dict(state["inner"])


def alternate(optimizers, composition):
    """Wrap each optimizer of a `composition` {alternate_iteration, order}
    in its AlternationGate (the JAX package's build.py wiring); `order`
    must name exactly the optimizers. An alternate_iteration of None, 0
    or 1 leaves them as they are (every member steps each step)."""
    alt = (composition or {}).get("alternate_iteration", 1)
    if alt in (None, 0, 1):
        return dict(optimizers)
    order = [s.strip() for s in str(composition["order"]).split(",")]
    if set(order) != set(optimizers):
        raise ValueError("composition order %s does not name the optimizers "
                         "%s" % (order, sorted(optimizers)))
    return {name: AlternationGate(optimizers[name], order.index(name),
                                  len(order), int(alt))
            for name in optimizers}
