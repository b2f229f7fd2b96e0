"""Optimizers with the reference's semantics (counterpart of
gandtr_tpu/learning/optimizers.py; the reference's base_optimizers.py).

The reference trains with torch's own `Adam`, whose weight decay is L2
added to the gradient (not AdamW's decoupled decay); the JAX package
rebuilds that as an optax chain. Here it is torch's optimizer itself.

Parameter groups follow the reference's `parameter_groups`:

- cirnet (cirnet.py:11-33, the JAX package's `_cirnet_leaf_mults`): the
  GeM `p` at lr x10 and weight decay 0, everything else x1;
- hed_interpolation (hed.py:86-112, `_hed_leaf_mults`): lr x1 for the VGG
  weights and x2 for their biases, x100 / x200 in block 5, x0.01 / x0.02
  for the score heads and x0.001 / x0.002 for the fusion; weight decay on
  the weights only.

Each group keeps its `lr_mult`, so a schedule sets lr = base_lr * lr_mult
* factor (`set_learning_rate`). Weight decay is torch Adam's own: L2 added
to the gradient, as the JAX package's `_decay_per_leaf` adds it before
the moments.
"""
import torch


def _cirnet_mults(name):
    if name == "pool.p" or name.endswith(".pool.p"):
        return 10.0, 0.0
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


GROUP_MULTS = {"cirnet": _cirnet_mults, "hed_interpolation": _hed_mults}


def param_groups(architecture, named_parameters):
    """[(lr_mult, wd_mult, [params])] for `architecture`: its table in
    GROUP_MULTS, or one group for an architecture the reference gives no
    groups (the GAN generators and discriminators)."""
    groups = {}
    for name, p in named_parameters:
        if not p.requires_grad:
            continue
        mults = GROUP_MULTS.get(architecture)
        key = mults(name) if mults else (1.0, 1.0)
        groups.setdefault(key, []).append(p)
    return [(lr, wd, ps) for (lr, wd), ps in groups.items()]


def initialize_optimizer(params, named_parameters, architecture=""):
    """A torch optimizer from a reference-style config {algorithm, lr,
    beta1, beta2, weight_decay}. Returns (optimizer, base_lr). Ported so
    far: Adam, the fine-tune's and the GANs'."""
    params = dict(params)
    algorithm = params.pop("algorithm")
    if algorithm != "adam":
        raise NotImplementedError("optimizer %r is not ported yet" % algorithm)
    lr = float(params.pop("lr"))
    wd = float(params.pop("weight_decay", 0.0))
    groups = [{"params": ps, "lr": lr * lr_mult, "weight_decay": wd * wd_mult,
               "lr_mult": lr_mult}
              for lr_mult, wd_mult, ps in param_groups(architecture,
                                                       named_parameters)]
    opt = torch.optim.Adam(groups, lr=lr,
                           betas=(float(params.pop("beta1", 0.9)),
                                  float(params.pop("beta2", 0.999))),
                           eps=1e-8, weight_decay=wd)
    return opt, lr


def set_learning_rate(optimizer, base_lr, factor=1.0):
    """Each group's lr = base_lr * its lr_mult * the schedule's factor."""
    for group in optimizer.param_groups:
        group["lr"] = base_lr * group.get("lr_mult", 1.0) * factor
