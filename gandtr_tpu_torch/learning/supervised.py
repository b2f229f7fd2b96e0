"""The GeM fine-tune tuple step (counterpart of
gandtr_tpu/learning/supervised.py; the reference's SupervisedEpoch with
fakebatch, supervised_epoch.py:50-107).

One step takes T tuples of S images, each tuple [query, positive,
negatives...]:

1. the frozen generator, in its eval form and without autograd, runs
   inside the augment net's wrapper chain (meanstd adaptation, masked
   CLAHE, the md5 ratio gate), on the tuple positions the gate can select;
2. the descriptor net embeds the S images (masked GeM over each image's
   valid rectangle);
3. the contrastive loss of the tuple; gradients reach only the descriptor
   net;
4. after all T tuples, one optimizer step.

With `fakebatch` each tuple's loss is backpropagated on its own and the
gradients accumulate in `.grad`: the reference's per-tuple backward, which
the JAX package emulates with a `scan` of rematerialised tuples. Without
it, the T losses are summed and backpropagated once. The reported loss is
the total over T tuples / T. Nothing in the step reads a device value on
the host, so the tuples queue on the card without a synchronisation.
"""
from dataclasses import dataclass
from typing import Any, Dict

import torch


@dataclass
class FinetuneState:
    models: Dict[str, Any]   # {"embed": WrappedNet, "augment": WrappedNet}
    optimizer: Any           # over the embed net's parameters
    step: int = 0

    def state_dict(self):
        """What a resume needs besides the networks' weights: the
        optimizer's state (Adam's moments and step counts, on the host) and
        the step count (the JAX package's `_AUX_FIELDS`)."""
        return {"optimizer": _to_cpu(self.optimizer.state_dict()),
                "step": int(self.step)}

    def load_state_dict(self, state):
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def make_finetune_state(models, optimizer):
    return FinetuneState(models=models, optimizer=optimizer, step=0)


def build_finetune_step(models, optimizer, criterion, fakebatch=True,
                        augment_positions=None):
    """Returns step(state, images, masks, labels, pass_mask) -> (state,
    {"total": loss}), with `criterion` a (D x S descriptors, labels,
    num_tuples) -> loss callable (learning/criteria.py):

      images:    (T, S, H, W, 3), generator-normalized (0.5 / 0.5)
      masks:     (T, S, H, W) valid-rectangle masks, or None
      labels:    (T, S) float: -1 query, 1 positive, 0 negative
      pass_mask: (T, S) bool: the augmentation gate of each image

    `augment_positions` (e.g. (0,)) runs the generator only on the tuple
    positions the gate can ever pass (the anchor under the published 'anc'
    gate): the same result at 1/S of the generator's work."""
    embed = models["embed"]
    augment = models.get("augment")
    def tuple_loss(imgs, msk, lbl, pmask):
        x = imgs
        if augment is not None:
            with torch.no_grad():
                out = augment.apply(x, ctx={"pass_mask": pmask}, train=True,
                                    model_positions=augment_positions,
                                    mask=msk)
            if isinstance(out, tuple):
                # the generator moved the valid rectangles of the rows it
                # transformed; the descriptor net pools over the new ones
                x, msk = out
            else:
                x = out
        descs = embed.apply(x, train=True, mask=msk)  # (S, D)
        return criterion(descs.T, lbl, num_tuples=1)

    def step(state, images, masks, labels, pass_mask):
        T = images.shape[0]
        optimizer.zero_grad(set_to_none=True)
        total = None
        if fakebatch:
            for t in range(T):
                loss = tuple_loss(images[t],
                                  None if masks is None else masks[t],
                                  labels[t], pass_mask[t])
                loss.backward()
                loss = loss.detach()
                total = loss if total is None else total + loss
        else:
            total = sum(tuple_loss(images[t],
                                   None if masks is None else masks[t],
                                   labels[t], pass_mask[t])
                        for t in range(T))
            total.backward()
            total = total.detach()
        optimizer.step()
        state.step += 1
        return state, {"total": total / T}

    return step
