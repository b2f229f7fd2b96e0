"""Epoch-level training (counterpart of gandtr_tpu/learning/training.py;
the reference's EpochTraining and TrainValLearning).

Each epoch: reseed (seed + the zero-based epoch, as the reference does),
set the epoch's learning rate, prepare the dataset (tuple mining), run the
step over the loader, log the weights' norms and histograms, close the
epoch's events, write the checkpoints, and hand the state to `state_hook`.
`resume_or_start` continues from the newest training file.

The step runs on the device without a synchronisation; the loop reads the
metrics back once per `chunk` steps (each step when `chunk` is 0 or 1).
The JAX package's `dispatch_chunk` compiles K steps into one scan; here
the K steps are the same K calls in the same order, and the chunk only
sets how far the loader prefetches and how often the host waits.
"""
import numpy as np
import torch

from gandtr_tpu_torch.data import transforms as T
from gandtr_tpu_torch.learning.optimizers import set_learning_rate


class EpochLoop:
    """step_fn(state, *batch_to_args(batch)) -> (state, {name: 0-dim
    tensor}) over a Loader, each metric logged per iteration."""

    def __init__(self, step_fn, loader, events=None, prefix="train/learning",
                 batch_to_args=None, chunk=0):
        self.step_fn = step_fn
        self.loader = loader
        self.events = events
        self.prefix = prefix
        self.batch_to_args = batch_to_args or (lambda batch: batch)
        self.chunk = int(chunk or 0)

    def run_epoch(self, state, epoch):
        logger = (self.events.logger(self.prefix, epoch, len(self.loader))
                  if self.events else (lambda *a, **k: None))
        if hasattr(self.loader.dataset, "prepare_epoch"):
            self.loader.dataset.prepare_epoch()
        pending, it = [], 0
        for batch in self.loader:
            state, metrics = self.step_fn(state, *self.batch_to_args(batch))
            pending.append(metrics)
            if len(pending) >= self.chunk:
                it = self._log(pending, it, logger)
                pending = []
        if pending:
            self._log(pending, it, logger)
        return state

    @staticmethod
    def _log(pending, it, logger):
        """Log the metrics of consecutive steps from `it` on, read off the
        device at once."""
        keys = list(pending[0])
        values = torch.stack([torch.stack([torch.as_tensor(m[k]).float()
                                           for k in keys])
                              for m in pending]).cpu().tolist()
        for j, row in enumerate(values):
            for key, value in zip(keys, row):
                logger(key, value, "scalar/loss", iteration=it + j)
        return it + len(pending)


class Training:
    """Epochs with the learning-rate schedule, events, checkpoints and
    resume. `state` is a FinetuneState (learning/supervised.py): its
    `models` are written as the reference's network files, with
    `net_params[name]` as each file's `network_params`."""

    def __init__(self, *, step_fn, loader, epochs, seed=0,
                 optimizers_base_lr=None, schedules=None, events=None,
                 checkpoints=None, frozen=(), batch_to_args=None,
                 state_hook=None, config_snapshot=None, chunk=0,
                 net_params=None):
        self.loop = EpochLoop(step_fn, loader, events,
                              batch_to_args=batch_to_args, chunk=chunk)
        self.epochs = epochs
        self.seed = seed
        self.base_lr = optimizers_base_lr or {}
        self.schedules = schedules or {}
        self.events = events
        self.checkpoints = checkpoints
        self.frozen = tuple(frozen)
        self.state_hook = state_hook
        # the data config persisted with each checkpoint; a resume under
        # another one is refused (the reference's learning.py)
        self.config_snapshot = config_snapshot
        self.net_params = net_params or {}

    def _apply_schedules(self, state, epoch):
        """This epoch's learning rate: base_lr x each group's multiplier x
        the schedule's factor for the zero-based epoch."""
        if self.schedules:
            ((name, sched),) = list(self.schedules.items())[:1]
            set_learning_rate(state.optimizer, self.base_lr.get(name, 1.0),
                              sched(epoch - 1))

    def _net_file(self, state, name):
        """The reference's flat network file of `state.models[name]`."""
        return {"type": "SingleNetwork", "frozen": name in self.frozen,
                "network_params": self.net_params.get(name),
                "model_state": {k: v.detach().cpu() for k, v in
                                state.models[name].module.state_dict()
                                .items()}}

    def run(self, state, start_epoch=1):
        for epoch in range(start_epoch, self.epochs + 1):
            # the reference reseeds with seed + the ZERO-based epoch
            T.seed_transforms(self.seed + epoch - 1)
            np.random.seed(self.seed + epoch - 1)
            self._apply_schedules(state, epoch)
            state = self.loop.run_epoch(state, epoch)

            is_best = True
            if self.events:
                self._log_weight_norms(state, epoch)
                self.events.close_epoch(epoch)
                is_best = self.events.metadata.is_last_best()

            if self.checkpoints:
                # the files are made only on the epochs that write them
                self.checkpoints.save_epoch(
                    epoch,
                    {name: (lambda name=name: self._net_file(state, name))
                     for name in state.models},
                    train_state=lambda: {
                        "epoch": epoch,
                        "config": self.config_snapshot,
                        "events": (self.events.state_dict() if self.events
                                   else None),
                        # Adam's moments and the step: the weights alone
                        # are not a faithful resume
                        "aux": state.state_dict()},
                    frozen=self.frozen, is_best=is_best,
                    is_last=(epoch == self.epochs))
            if self.state_hook:
                self.state_hook(state, epoch)
        return state

    def _log_weight_norms(self, state, epoch):
        """Each network's parameter L2 norm (a score) and each parameter's
        histogram (weight/param), as the reference logs them."""
        logger = self.events.logger("train/weights", epoch)
        for name, net in state.models.items():
            params = [(k, p.detach()) for k, p in
                      net.module.named_parameters()]
            sq = torch.stack([p.float().square().sum() for _, p in params])
            logger(f"{name}/l2", float(np.sqrt(sum(sq.cpu().tolist()))),
                   "scalar/score")
            logger(f"{name}/params", {k: p.float().cpu().numpy()
                                      for k, p in params}, "weight/param")

    def resume_or_start(self, state):
        """Resume from the newest training file: the networks' weights,
        the optimizer's state, the step and the events. Returns (state,
        start_epoch). Refuses a checkpoint written under another data
        config."""
        if not self.checkpoints:
            return state, 1
        epoch, train_meta = self.checkpoints.load_latest_epoch()
        if epoch is None:
            return state, 1
        saved_cfg = (train_meta or {}).get("config")
        if (saved_cfg is not None and self.config_snapshot is not None
                and saved_cfg != self.config_snapshot):
            raise RuntimeError(
                "resume config mismatch:\ncheckpoint: %r\ncurrent:    %r"
                % (saved_cfg, self.config_snapshot))
        for name, net in state.models.items():
            net.module.load_state_dict(
                self.checkpoints.load_net(name, epoch)["model_state"],
                strict=True)
        if train_meta and train_meta.get("aux"):
            state.load_state_dict(train_meta["aux"])
        if self.events and train_meta and train_meta.get("events"):
            self.events.load_state_dict(train_meta["events"])
        return state, epoch + 1


def should_validate(frequency, epoch):
    """The reference's rule for 1-based epochs: `epoch=None` (a validate
    stage outside training) always validates, a falsy frequency never
    does during training, else every `frequency`-th epoch."""
    return epoch is None or (bool(frequency) and epoch % int(frequency) == 0)
