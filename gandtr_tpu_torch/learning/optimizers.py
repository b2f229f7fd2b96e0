"""Optimizers with the reference's semantics (counterpart of
gandtr_tpu/learning/optimizers.py; the reference's base_optimizers.py).

The reference trains with torch's own `Adam`, whose weight decay is L2
added to the gradient (not AdamW's decoupled decay); the JAX package
rebuilds that as an optax chain. Here it is torch's optimizer itself.

Parameter groups follow the reference's `parameter_groups`
(cirnet.py:11-33, the JAX package's `_cirnet_leaf_mults`) for the ported
cirnet (GeM-VGG16): the GeM `p` at lr x10 and weight decay 0, everything
else x1. Each group keeps its `lr_mult`, so a schedule
sets lr = base_lr * lr_mult * factor (`set_learning_rate`).
"""
import torch

def _cirnet_mults(name):
    if name == "pool.p" or name.endswith(".pool.p"):
        return 10.0, 0.0
    return 1.0, 1.0


def param_groups(architecture, named_parameters):
    """[(lr_mult, wd_mult, [params])] for `architecture`: the cirnet table,
    or one group for an architecture the reference gives no groups."""
    groups = {}
    for name, p in named_parameters:
        if not p.requires_grad:
            continue
        key = _cirnet_mults(name) if architecture == "cirnet" else (1.0, 1.0)
        groups.setdefault(key, []).append(p)
    return [(lr, wd, ps) for (lr, wd), ps in groups.items()]


def initialize_optimizer(params, named_parameters, architecture=""):
    """A torch optimizer from a reference-style config {algorithm, lr,
    beta1, beta2, weight_decay}. Returns (optimizer, base_lr). Ported so
    far: the fine-tune's Adam."""
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
