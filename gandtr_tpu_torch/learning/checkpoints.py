"""Per-epoch checkpoints of a multi-network experiment (counterpart of
gandtr_tpu/learning/checkpoints.py; the reference's checkpoints.py).

Files under `<directory>/epochs/`:

- `<name>_epoch_%02d.ckpt`, one per network and written epoch, in the
  reference's flat torch format {"type", "frozen", "network_params",
  "model_state"} (`torch.save`; the port's hub and the JAX package's
  `normalize_network_checkpoint` read it);
- `<name>_best.ckpt` / `<name>_last.ckpt`: symlinks to an epoch file, or
  the file itself on an epoch that writes no epoch file;
- `<name>_frozen.ckpt`: a frozen network, stored once, linked from each
  epoch;
- `training_epoch_%02d.pkl`: what a resume needs besides the networks
  (epoch, config snapshot, events, optimizer state), also `torch.save`.

`checkpoint_every` epochs are kept until the next one is written,
`store_every` epochs for good; the last epoch is always written. Every
write goes to `.tmp` and is renamed into place.
"""
import io
import os
import pickle
import re
import shutil

import torch

BEST_SUFFIX = "_best"
LAST_SUFFIX = "_last"
FROZEN_SUFFIX = "_frozen"


def _serialize(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


class Checkpoints:
    def __init__(self, directory, store_every=10, checkpoint_every=2,
                 directory_epoch_regex=None):
        self.directory = directory
        self.epochs_dir = os.path.join(directory, "epochs")
        self.store_every = int(store_every) if store_every else 0
        self.checkpoint_every = int(checkpoint_every) if checkpoint_every \
            else 0
        # a 3-group regex over the epochs directory's path (prefix, epoch
        # count, postfix): resume from a finished sibling experiment with
        # fewer epochs
        self.directory_epoch_regex = directory_epoch_regex
        # the epoch adopted from a sibling experiment; its files live there,
        # and the GC never targets it or an earlier epoch
        self.epoch_externally_loaded = 0
        self._adopted = None   # (sibling epochs dir, epoch)
        os.makedirs(self.epochs_dir, exist_ok=True)

    # --- paths ---

    def _net_path(self, name, epoch):
        return os.path.join(self.epochs_dir,
                            "%s_epoch_%02d.ckpt" % (name, epoch))

    def _link_path(self, name, suffix):
        return os.path.join(self.epochs_dir, "%s%s.ckpt" % (name, suffix))

    def _train_path(self, epoch):
        return os.path.join(self.epochs_dir, "training_epoch_%02d.pkl" % epoch)

    # --- save ---

    @staticmethod
    def _atomic_write(path, data):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    @staticmethod
    def _symlink(target, link):
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(os.path.basename(target), link)

    def save_notrain(self, net_files):
        """Zero-epoch training: each network as `<name>_notrain.ckpt`, with
        `_best` and `_last` linked to it."""
        for name, net_file in net_files.items():
            path = os.path.join(self.epochs_dir, "%s_notrain.ckpt" % name)
            self._atomic_write(path, _serialize(net_file))
            self._symlink(path, self._link_path(name, BEST_SUFFIX))
            self._symlink(path, self._link_path(name, LAST_SUFFIX))

    def save_epoch(self, epoch, net_files, train_state=None, frozen=(),
                   is_best=False, is_last=False):
        """net_files: {name: the network's flat file dict, or a callable
        that makes it}. `train_state` (or a callable that makes it) is
        written with the epoch files. A frozen network is stored once and
        linked; the epoch files and the training file are written on
        `checkpoint_every` / `store_every` epochs and the last one, and
        `_best` / `_last` of another epoch get the network file itself."""
        is_checkpointed = (self.checkpoint_every > 0
                           and epoch % self.checkpoint_every == 0) or is_last
        is_stored = self.store_every > 0 and epoch % self.store_every == 0
        write_epoch = is_checkpointed or is_stored
        if callable(train_state):
            train_state = train_state() if write_epoch else None
        for name, net_file in net_files.items():
            path = self._net_path(name, epoch)
            if name in frozen:
                frozen_path = self._link_path(name, FROZEN_SUFFIX)
                if not os.path.exists(frozen_path):
                    self._atomic_write(frozen_path, _serialize(
                        net_file() if callable(net_file) else net_file))
                if write_epoch:
                    self._symlink(frozen_path, path)
                for cond, suffix in ((is_best, BEST_SUFFIX),
                                     (is_last, LAST_SUFFIX)):
                    if cond:
                        self._symlink(frozen_path,
                                      self._link_path(name, suffix))
                continue
            data = None
            if write_epoch or is_best or is_last:
                data = _serialize(net_file() if callable(net_file)
                                  else net_file)
            if write_epoch:
                self._atomic_write(path, data)
            for cond, suffix in ((is_best, BEST_SUFFIX),
                                 (is_last, LAST_SUFFIX)):
                if not cond:
                    continue
                link = self._link_path(name, suffix)
                if write_epoch:
                    self._symlink(path, link)
                else:
                    if os.path.islink(link):
                        os.remove(link)
                    self._atomic_write(link, data)

        if train_state is not None and write_epoch:
            self._atomic_write(self._train_path(epoch),
                               _serialize(train_state))

        # the reference's GC: only when a new checkpoint was written, and
        # only the previous checkpoint epoch: its training file always, its
        # network files unless it is a store_every epoch
        if is_checkpointed:
            prev = (epoch - (epoch % self.checkpoint_every
                             or self.checkpoint_every)
                    if self.checkpoint_every > 0 else 0)
            if prev <= self.epoch_externally_loaded:
                prev = 0
            if prev >= 1:
                tp = self._train_path(prev)
                if os.path.exists(tp):
                    os.remove(tp)
                prev_is_stored = (self.store_every > 0
                                  and prev % self.store_every == 0)
                if not prev_is_stored:
                    for name in net_files:
                        self._gc_net(name, prev)

    def _gc_net(self, name, epoch):
        """Delete one network's file of a collected epoch. Where `_best`
        links to it, the file moves into `_best` instead (the reference
        renames it to `_bestsofar`)."""
        p = self._net_path(name, epoch)
        if not os.path.lexists(p):
            return
        if os.path.islink(p):
            # a frozen network's link; best / last link the frozen file
            os.remove(p)
            return
        best = self._link_path(name, BEST_SUFFIX)
        if os.path.islink(best) and \
                os.path.realpath(best) == os.path.realpath(p):
            os.remove(best)
            os.rename(p, best)
        else:
            os.remove(p)

    # --- load ---

    def load_net(self, name, epoch_or_suffix):
        """The network file dict of an epoch (int) or a shortcut suffix
        ("_best", "_last", "_frozen")."""
        if isinstance(epoch_or_suffix, int):
            path = self._net_path(name, epoch_or_suffix)
            if not os.path.exists(path) and self._adopted \
                    and self._adopted[1] == epoch_or_suffix:
                # an adopted epoch's networks live in the sibling directory
                path = os.path.join(
                    self._adopted[0],
                    "%s_epoch_%02d.ckpt" % (name, epoch_or_suffix))
        else:
            path = self._link_path(name, epoch_or_suffix)
        return _load(path)

    def available_epochs(self):
        eps = set()
        for fn in os.listdir(self.epochs_dir):
            if fn.startswith("training_epoch_") and fn.endswith(".pkl"):
                eps.add(int(fn[len("training_epoch_"):-len(".pkl")]))
        return sorted(eps)

    def load_latest_epoch(self):
        """(epoch, train_state) of the newest readable training file, or
        (None, None). With none here and `directory_epoch_regex` set, a
        finished sibling experiment with fewer epochs is adopted."""
        for epoch in reversed(self.available_epochs()):
            try:
                return epoch, _load(self._train_path(epoch))
            except (EOFError, RuntimeError, pickle.UnpicklingError):
                continue  # a torn file: try the previous epoch
        if self.directory_epoch_regex:
            adopted = self.adopt_previous_experiment()
            if adopted is not None:
                return adopted
        return None, None

    def adopt_previous_experiment(self):
        """Continue from a finished experiment with fewer epochs (the
        reference's checkpoints.py): `directory_epoch_regex`'s group 2 is
        the epoch count in this experiment's epochs path; sibling paths
        take smaller counts there. The newest sibling whose last training
        file exists is adopted: its `_best` networks and blobs are copied
        in, its epoch files stay there (`load_net` reads them), and
        (epoch, train_state) is returned."""
        path = os.path.abspath(self.epochs_dir)
        m = re.search(self.directory_epoch_regex, path)
        if not m or len(m.groups()) != 3:
            raise ValueError("directory_epoch_regex %r must match %r with 3 "
                             "groups (prefix, epoch, postfix)"
                             % (self.directory_epoch_regex, path))
        for epoch1 in reversed(range(1, int(m.group(2)))):
            src = "%s%s%s" % (m.group(1), epoch1, m.group(3))
            tp = os.path.join(src, "training_epoch_%02d.pkl" % epoch1)
            if not os.path.isdir(src) or not os.path.exists(tp):
                continue
            suffix = "_epoch_%02d.ckpt" % epoch1
            names = sorted(fn[:-len(suffix)] for fn in os.listdir(src)
                           if fn.endswith(suffix))
            if not names:
                continue
            for name in names:
                # the epochs were parsed right: _last resolves to the file
                last = os.path.join(src, name + LAST_SUFFIX + ".ckpt")
                if os.path.lexists(last) and os.path.realpath(last) != \
                        os.path.realpath(os.path.join(src, name + suffix)):
                    raise ValueError("%s does not resolve to %s"
                                     % (last, name + suffix))
            for name in names:
                best = os.path.join(src, name + BEST_SUFFIX + ".ckpt")
                if os.path.lexists(best):
                    shutil.copyfile(os.path.realpath(best),
                                    self._link_path(name, BEST_SUFFIX))
            src_blobs = os.path.join(src, "blobs")
            if os.path.isdir(src_blobs):
                dst_blobs = os.path.join(self.epochs_dir, "blobs")
                if os.path.isdir(dst_blobs):
                    shutil.rmtree(dst_blobs)
                shutil.copytree(src_blobs, dst_blobs)
            state = _load(tp)
            self.epoch_externally_loaded = epoch1
            self._adopted = (src, epoch1)
            print(">> Loading epoch %02d from experiment %s" % (epoch1, src))
            return epoch1, state
        return None


def load_network_file(path):
    """A standalone network file's dict."""
    return _load(path)


def adopt_from_directory_regex(checkpoints, directory_epoch_regex):
    """Adopt a sibling experiment under the 3-group regex when this one
    has no epochs yet. Returns (epoch, train_state) or None."""
    if checkpoints.available_epochs():
        return None
    checkpoints.directory_epoch_regex = directory_epoch_regex
    return checkpoints.adopt_previous_experiment()
