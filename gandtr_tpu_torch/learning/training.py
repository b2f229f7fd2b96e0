"""Epoch-level training (counterpart of gandtr_tpu/learning/training.py;
the reference's EpochTraining and TrainValLearning).

Each epoch: reseed (seed + the zero-based epoch, as the reference does),
set the epoch's learning rate of each optimizer, prepare the dataset
(tuple mining, or the GAN's domain pairs), run the step over the loader,
log the weights' norms and histograms and, on the first and every fifth
epoch, the last batch's sample images, run the validations, close the
epoch's events, write the checkpoints, and hand the state to
`state_hook`. `resume_or_start` continues from the newest training file.

The step runs on the device without a synchronisation; the loop reads the
metrics back once per `chunk` steps (each step when `chunk` is 0 or 1).
The JAX package's `dispatch_chunk` compiles K steps into one scan; here
the K steps are the same K calls in the same order, and the chunk only
sets how far the loader prefetches and how often the host waits.

`VisualValidation` (the GAN configs' visual criterion, inside a
`MultiCriterialValidation`) runs the generator in eval mode over fixed
validation images and logs its outputs as blobs. `LossValidation` is the
fine-tune's validation loss over val tuples mined with the current
weights, `ScoreValidation` a retrieval eval (mAP) of the embed on a test
set during training.

`profile_dir` (`output.learning.profile`) writes a torch.profiler Chrome
trace of epoch min(2, epochs) into that directory (the JAX package writes
a jax.profiler trace of the same epoch).
"""
import os
import time

import numpy as np
import torch

from gandtr_tpu_torch.data import transforms as T
from gandtr_tpu_torch.learning.optimizers import set_learning_rate
from gandtr_tpu_torch.parallel import mesh


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
        """Run the epoch; a step that returns (state, metrics, debug) leaves
        its last debug dict in `last_debug`."""
        logger = (self.events.logger(self.prefix, epoch, len(self.loader))
                  if self.events else (lambda *a, **k: None))
        if hasattr(self.loader.dataset, "prepare_epoch"):
            self.loader.dataset.prepare_epoch()
        pending, it = [], 0
        self.last_debug = None
        for batch in self.loader:
            out = self.step_fn(state, *self.batch_to_args(batch))
            state, metrics = out[:2]
            if len(out) == 3:
                self.last_debug = out[2]
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
    """Epochs with the learning-rate schedules, events, validations,
    checkpoints and resume. `state` is a FinetuneState (one `optimizer`,
    learning/supervised.py) or a GanState (`optimizers` by network,
    learning/gan_steps.py): its `models` are written as the reference's
    network files, with `net_params[name]` as each file's
    `network_params`. `rng_states` ({name: numpy RandomState}) are saved
    with each training file and restored on resume (the GAN loader's
    shuffle), so a resumed epoch draws what the straight run drew."""

    #: the reference's supervised_epoch.py:13: sample images of the last
    #: batch on the first epoch and every fifth
    LOG_TRAINDATA_SAMPLE_EVERY = 5

    def __init__(self, *, step_fn, loader, epochs, seed=0,
                 optimizers_base_lr=None, schedules=None, events=None,
                 checkpoints=None, frozen=(), batch_to_args=None,
                 state_hook=None, config_snapshot=None, chunk=0,
                 net_params=None, validations=(), mean_std=None,
                 rng_states=None, profile_dir=None):
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
        self.validations = list(validations)
        self.mean_std = mean_std or ([0.5] * 3, [0.5] * 3)
        self.rng_states = dict(rng_states or {})
        self.profile_dir = profile_dir

    def _apply_schedules(self, state, epoch):
        """This epoch's learning rate: base_lr x each group's multiplier x
        the schedule's factor for the zero-based epoch, for each
        optimizer with a schedule."""
        optimizers = getattr(state, "optimizers", None)
        if optimizers is not None:
            for name, sched in self.schedules.items():
                if name in optimizers:
                    set_learning_rate(optimizers[name],
                                      self.base_lr.get(name, 1.0),
                                      sched(epoch - 1))
        elif self.schedules:
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
            if self.profile_dir and epoch == min(2, self.epochs):
                state = self._profiled_epoch(state, epoch)
            else:
                state = self.loop.run_epoch(state, epoch)
            debug = getattr(self.loop, "last_debug", None)

            if self.events:
                self._log_weight_norms(state, epoch)
                if debug and (epoch == 1 or epoch
                              % self.LOG_TRAINDATA_SAMPLE_EVERY == 0):
                    self._log_traindata_sample(debug, epoch)
            for val in self.validations:
                val(state, epoch, self.events)

            is_best = True
            if self.events:
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
                        "aux": state.state_dict(),
                        "rngs": {k: _rng_state(rs) for k, rs in
                                 self.rng_states.items()}},
                    frozen=self.frozen, is_best=is_best,
                    is_last=(epoch == self.epochs))
            if self.state_hook:
                self.state_hook(state, epoch)
        return state

    def _profiled_epoch(self, state, epoch):
        """The epoch under torch.profiler (the card's kernels too where
        the state lives there), its Chrome trace written to
        `<profile_dir>/epoch_<epoch>.trace.json`."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            state = self.loop.run_epoch(state, epoch)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        if not mesh.is_writer():
            return state
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.profile_dir, "epoch_%02d.trace.json" % epoch))
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

    def _log_traindata_sample(self, debug, epoch):
        """The last batch's sample images as blobs (supervised_epoch.py:
        116-156): `data/<label>/image0.rgb` for the first three channels
        of a 3-channel image, denormalized, and `data/<label>/image0.chan1`
        for a 1-channel map, taken raw; maps under 20 pixels are
        skipped."""
        logger = self.events.logger("data", epoch)
        mean = np.asarray(self.mean_std[0], np.float32)
        std = np.asarray(self.mean_std[1], np.float32)
        for label, img in debug.items():
            img = img.detach().float().cpu().numpy()
            if img.ndim == 4:
                img = img[0]
            if img.ndim != 3 or min(img.shape[:2]) < 20:
                continue
            c = img.shape[-1]
            if c != 1 and c != len(mean):
                continue
            m, s = mean, std
            if c == 1 and len(mean) > 1:
                m, s = np.zeros(1, np.float32), np.ones(1, np.float32)
            if c >= 3:
                logger("%s/image0.rgb" % label,
                       np.clip(img[..., :3] * s[:3] + m[:3], 0, 1), "blob")
            for k in range(3 if c >= 3 else 0, c):
                logger("%s/image0.chan%d" % (label, k + 1),
                       np.clip(img[..., k] * s[k] + m[k], 0, 1), "blob")

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
        for name, saved in ((train_meta or {}).get("rngs") or {}).items():
            if name in self.rng_states:
                kind, keys, pos, has_gauss, cached = saved
                self.rng_states[name].set_state(
                    (kind, np.asarray(keys, np.uint32), pos, has_gauss,
                     cached))
        if self.events and train_meta and train_meta.get("events"):
            self.events.load_state_dict(train_meta["events"])
        # every rank loaded the same files; rank 0's copy is the one
        mesh.replicate_tree(state)
        return state, epoch + 1


def _rng_state(rs):
    """A RandomState's state in plain types (the training file is read
    back with torch's weights-only loader)."""
    kind, keys, pos, has_gauss, cached = rs.get_state()
    return [kind, keys.tolist(), int(pos), int(has_gauss), float(cached)]


def should_validate(frequency, epoch):
    """The reference's rule for 1-based epochs: `epoch=None` (a validate
    stage outside training) always validates, a falsy frequency never
    does during training, else every `frequency`-th epoch."""
    return epoch is None or (bool(frequency) and epoch % int(frequency) == 0)


class VisualValidation:
    """The generator over fixed validation images, its outputs logged as
    blobs `val/visual/<image stem>` (the reference's optim/score/visual.py
    :12-91) every `frequency` epochs; the generator is the state's
    `net_name` network. `images` is a list of normalized (H,
    W, C) tensors, run one at a time (the aspect-keeping downscale gives
    them different shapes); the generator runs in eval mode, without
    autograd, and is put back in its mode after."""

    def __init__(self, images, mean_std=((0.5,) * 3, (0.5,) * 3),
                 net_name="generator_X", key="val/visual", frequency=1,
                 names=None):
        self.images = list(images)
        self.mean = np.asarray(mean_std[0], np.float32)
        self.std = np.asarray(mean_std[1], np.float32)
        self.net_name = net_name
        self.key = key
        self.frequency = frequency
        self.names = ([n.rsplit("/", 1)[-1].rsplit(".", 1)[0] for n in names]
                      if names else None)

    def __call__(self, state, epoch, events):
        if events is None or not should_validate(self.frequency, epoch):
            return
        module = state.models[self.net_name].module
        mode = module.training
        module.eval()
        try:
            dev = next(module.parameters()).device
            with torch.no_grad():
                outs = [module(img[None].to(dev))[0].float().cpu().numpy()
                        for img in self.images]
        finally:
            module.train(mode)
        logger = events.logger("", epoch)
        for i, img in enumerate(outs):
            c = img.shape[-1]
            m, s = self.mean, self.std
            if c == 1 and len(m) > 1:
                m, s = np.zeros(1, np.float32), np.ones(1, np.float32)
            rgb = np.clip(img * s[:c] + m[:c], 0, 1)
            if rgb.shape[-1] == 1:
                rgb = rgb[..., 0]
            label = self.names[i] if self.names and i < len(self.names) \
                else str(i)
            logger("%s/%s" % (self.key, label), rgb, "blob")


class MultiCriterialValidation:
    """Named child validations run in turn (validation.py:121-156); the
    decisive criterion goes to the events' MetadataKeeper."""

    def __init__(self, children, decisive_criterion=None):
        self.children = dict(children)
        self.decisive_criterion = decisive_criterion

    def __call__(self, state, epoch, events):
        for child in self.children.values():
            child(state, epoch, events)


class LossValidation:
    """The reference's SingleValidation (validation.py:60-118): the
    criterion's loss over a validation loader every `frequency` epochs,
    its mean logged under `key`. `on_validate(state)` runs first, before
    the dataset's `prepare_epoch`, so the validation tuples are mined with
    the current weights (validation.py:87). A sum-reduced criterion
    (`criterion_mean_reduction=False`) is divided by the batch's tuples
    (validation.py:99-101). `loss_fn(state, *batch_to_args(batch))`
    returns a 0-dim tensor; the losses are read back once, at the end."""

    def __init__(self, loss_fn, loader, frequency=1,
                 key="val/learning/loss:total", batch_to_args=None,
                 criterion_mean_reduction=True, on_validate=None):
        self.loss_fn = loss_fn
        self.loader = loader
        self.frequency = frequency
        self.key = key
        self.batch_to_args = batch_to_args or (lambda batch: batch)
        self.criterion_mean_reduction = criterion_mean_reduction
        self.on_validate = on_validate
        self.last_seconds = None

    def __call__(self, state, epoch, events):
        if not should_validate(self.frequency, epoch):
            return
        t0 = time.perf_counter()
        if self.on_validate is not None:
            self.on_validate(state)
        if hasattr(self.loader.dataset, "prepare_epoch"):
            self.loader.dataset.prepare_epoch()
        losses = []
        with torch.no_grad():
            for batch in self.loader:
                loss = self.loss_fn(state, *self.batch_to_args(batch))
                if not self.criterion_mean_reduction:
                    loss = loss / max(len(batch[0]), 1)
                losses.append(loss.float())
        values = torch.stack(losses).cpu().tolist() if losses else []
        self.last_seconds = time.perf_counter() - t0
        if events and values:
            events.logger("", epoch)(self.key, float(np.mean(values)),
                                     "scalar/loss")


class ScoreValidation:
    """The reference's CirDatasetAp (optim/score/cirscore.py:51-83): every
    `frequency` epochs, the retrieval eval of the state's `net_name`
    network (`embed_net` for a state without models) on a test set,
    logged as `<key_prefix>/<dataset>/dataset:eval` (seconds),
    `.../score_avg:<m>` for each mAP and `.../score:<m>` for each query's
    AP (`iteration` its index). `dataset` is a name under `dir_main`
    (eval/retrieval.py::configdataset) or the reference's tsv form {name,
    queries, db, imgdir}, parsed once.

    `transform` is a host transform (a callable), or a transform string
    split as the validate stage splits it (`pil2np [| apply_clahe] |
    totensor | normalize`: decoding on the host, CLAHE and the
    normalization on the network's device, with the `mean_std` of its
    `data` params); None takes the network's own `data` params. Each
    image is embedded at its own shape. No build key makes it: append it
    to a Training's `validations`."""

    def __init__(self, embed_net, dataset, dir_main, image_size=1024,
                 transform=None, frequency=1, net_name="embed",
                 key_prefix="val/validation"):
        self.embed_net = embed_net
        self.dataset = dataset
        self.dir_main = dir_main
        self.image_size = image_size
        self.transform = transform
        self.frequency = frequency
        self.net_name = net_name
        self.key_prefix = key_prefix
        self._cfg = None
        self.last_seconds = None

    def _dataset_cfg(self):
        if self._cfg is None:
            from gandtr_tpu_torch.eval.retrieval import (configdataset,
                                                         configdataset_tsv)
            self._cfg = (configdataset_tsv(self.dataset)
                         if isinstance(self.dataset, dict)
                         else configdataset(self.dataset, self.dir_main))
        return self._cfg

    def _extractor(self, net):
        """(ShapeCachedExtractor on the network's device, host
        transform)."""
        from gandtr_tpu_torch.eval.retrieval import ShapeCachedExtractor
        transform, device_pre = self.transform, None
        if transform is None or isinstance(transform, str):
            data = net.data_params or {}
            tf_str = transform or data.get("transforms")
            mean_std = data.get("mean_std")
            transform, device_pre = T.split_device_transform(tf_str, mean_std)
            if device_pre is None:
                transform = T.initialize_transforms(tf_str, mean_std)

        def forward(x):
            if device_pre is not None:
                xf = x.float() / 255.0 if x.dtype == torch.uint8 \
                    else x.float()
                x = device_pre(xf, None)
            return net.apply(x, train=False)
        device = next(net.module.parameters()).device
        return ShapeCachedExtractor(forward, device=device), transform

    def __call__(self, state, epoch, events):
        if not should_validate(self.frequency, epoch):
            return
        from gandtr_tpu_torch.eval.retrieval import evaluate_dataset
        models = getattr(state, "models", None) or {}
        net = models.get(self.net_name, self.embed_net)
        cfg = self._dataset_cfg()
        t0 = time.perf_counter()
        extractor, transform = self._extractor(net)
        metrics, aps, _, _ = evaluate_dataset(extractor, cfg, self.image_size,
                                              transform)
        self.last_seconds = time.perf_counter() - t0
        if not events:
            return
        nq = len(next(iter(aps.values()))) if aps else 0
        logger = events.logger("", epoch, epoch_size=nq)
        head = "%s/%s" % (self.key_prefix, cfg["dataset"])
        logger(head + "/dataset:eval", self.last_seconds, "scalar/time")
        for mk, mv in metrics.items():
            logger("%s/score_avg:%s" % (head, mk), float(mv), "scalar/score")
        for mk, mv in aps.items():
            for i, v in enumerate(np.asarray(mv).tolist()):
                logger("%s/score:%s" % (head, mk), float(v), "scalar/score",
                       iteration=i)
