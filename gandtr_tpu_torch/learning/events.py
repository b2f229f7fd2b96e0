"""Training events: the metrics funnel, progress printing and best-epoch
bookkeeping (counterpart of gandtr_tpu/learning/events.py; the reference's
eventprocessor.py).

Every loop emits `(epoch, iteration, epoch_size, key, value, dtype)`
through a logger closure. Streamers act on each event (stderr progress);
the broker aggregates scalars per epoch, reduces `weight/*` arrays to
200-bin histograms, writes each histogram as an SVG under
`<dir>/epochs/blobs/` and the per-epoch history to `epochs/events.json`;
the MetadataKeeper picks the best epoch by a decisive criterion.

dtypes: "scalar/loss", "scalar/score", "scalar/time", "weight/param",
"weight/grad"; the JAX package's "blob" and "heatmap" (sample images of
the GAN paths) are not ported yet. Host numpy only: the caller reads
values off the device.
"""
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np


class MetadataKeeper:
    """Per-key epoch series with the reference's best-epoch rules:

    - a "scalar/score" is better higher, anything else lower;
    - the criterion "epoch" makes every epoch best;
    - a criterion not updated at the latest closed epoch is never "last
      best" (validation every few epochs);
    - on a tie with an earlier epoch the last one still counts as best,
      while `best_epoch()` reports the first.

    With no criterion (no validation) every epoch is best, so `_best`
    follows `_last`."""

    def __init__(self, decisive_criterion=None):
        self.decisive_criterion = decisive_criterion
        self.metrics = defaultdict(dict)  # key -> {epoch: value}
        self.dtypes = {}                  # key -> dtype
        self.epochs = []                  # closed epochs, in order

    def add(self, epoch, key, value, dtype="scalar/loss"):
        self.metrics[key][epoch] = value
        self.dtypes[key] = dtype

    def note_epoch(self, epoch):
        if not self.epochs or self.epochs[-1] != epoch:
            self.epochs.append(epoch)

    def series(self, key):
        d = self.metrics.get(key, {})
        return [d[e] for e in sorted(d)]

    def _higher_is_better(self, key):
        return self.dtypes.get(key) == "scalar/score"

    def best_epoch(self):
        key = self.decisive_criterion
        if key == "epoch":
            return self.epochs[-1] if self.epochs else None
        if not key or key not in self.metrics:
            return None
        d = self.metrics[key]
        es = sorted(d)
        vals = [d[e] for e in es]
        idx = int(np.argmax(vals)) if self._higher_is_better(key) \
            else int(np.argmin(vals))
        return es[idx]

    def is_last_best(self):
        key = self.decisive_criterion
        if key is None or key == "epoch":
            return True
        if key not in self.metrics:
            return False
        d = self.metrics[key]
        if self.epochs and max(d) != self.epochs[-1]:
            return False
        vals = [d[e] for e in sorted(d)]
        best = max(vals) if self._higher_is_better(key) else min(vals)
        return vals[-1] == best

    def state_dict(self):
        return {"metrics": {k: dict(v) for k, v in self.metrics.items()},
                "dtypes": dict(self.dtypes),
                "epochs": list(self.epochs),
                "decisive_criterion": self.decisive_criterion}

    def load_state_dict(self, state):
        self.decisive_criterion = state["decisive_criterion"]
        self.dtypes = dict(state.get("dtypes") or {})
        self.epochs = [int(e) for e in state.get("epochs") or []]
        self.metrics = defaultdict(dict)
        for k, v in state["metrics"].items():
            self.metrics[k] = {int(e): val for e, val in v.items()}


class DebugPrinter:
    """Stderr progress: the running mean of each `.../total` loss, seconds
    a batch and minutes an epoch, every `print_each` iterations (falsy:
    silent; `print_each_val` for keys under "val/")."""

    def __init__(self, print_each=100, print_each_val=None):
        self.print_each = print_each
        self.print_each_val = (print_each_val if print_each_val is not None
                               else print_each)
        self._start = None
        self._acc = defaultdict(list)

    def register(self, epoch, iteration, epoch_size, key, value, dtype):
        if not dtype.startswith("scalar") or not self.print_each:
            return
        if self._start is None:
            self._start = time.time()
        self._acc[key].append(float(value))
        if key.endswith("/total") and iteration is not None:
            each = self.print_each_val if key.split("/", 1)[0] == "val" \
                else self.print_each
            if (iteration + 1) % each == 0 or iteration + 1 == epoch_size:
                vals = self._acc[key]
                elapsed = time.time() - self._start
                sb = elapsed / max(len(vals), 1)
                print(f">> epoch {epoch} [{iteration + 1}/{epoch_size}] "
                      f"{key}: {np.mean(vals):.4f} ({sb:.2f}s/b, "
                      f"{sb * epoch_size / 60:.1f}min/epoch)", file=sys.stderr)

    def close_epoch(self, epoch):
        self._acc.clear()
        self._start = None


HISTOGRAM_BINS = 200  # eventprocessor.py


def compute_histogram(value, bins=HISTOGRAM_BINS):
    """Array -> (bin_centers, counts), the reference's _generate_hist."""
    v = np.asarray(value, np.float64).ravel()
    counts, edges = np.histogram(v, bins=bins, density=False)
    return (edges[:-1] + edges[1:]) / 2, counts


def _svg_histogram(hists, width=420, height=120):
    """{subkey: (centers, counts)} -> a standalone SVG, one bar panel per
    subkey."""
    panels = []
    y0 = 0
    for subkey, (centers, counts) in hists.items():
        counts = np.asarray(counts, np.float64)
        peak = counts.max() or 1.0
        n = len(counts)
        bw = (width - 20) / n
        bars = "".join(
            '<rect x="%.1f" y="%.1f" width="%.2f" height="%.1f" fill="#579"/>'
            % (10 + i * bw, y0 + height - 14 - h, max(bw - 0.2, 0.3), h)
            for i, h in enumerate((counts / peak) * (height - 30)))
        label = ("%s  [%.3g, %.3g]" % (subkey, centers[0], centers[-1])
                 if len(centers) else subkey)
        panels.append(
            f'<g>{bars}<text x="12" y="{y0 + 12}" font-size="10">'
            f"{label}</text></g>")
        y0 += height
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{y0}" style="background:#fafafa">' + "".join(panels)
            + "</svg>")


class EventBroker:
    """Fans each event out to the streamers, aggregates per epoch and keeps
    the history (eventprocessor.py's broker). Arrays of weight/* events are
    not kept, only their histograms."""

    AGGREGATIONS = {"scalar/loss": "avg", "scalar/score": "avg",
                    "scalar/time": "sum"}

    def __init__(self, directory=None, streamers=(), metadata=None):
        self.directory = directory
        self.streamers = list(streamers)
        self.metadata = metadata or MetadataKeeper()
        self.iter_keys = set()  # scalar keys logged with an iteration index
        self._epoch_acc = defaultdict(list)
        self._epoch_hists = {}
        self.histograms = defaultdict(dict)  # key -> {epoch: {subkey: hist}}
        self.history = []
        if directory:
            os.makedirs(os.path.join(directory, "epochs", "blobs"),
                        exist_ok=True)

    def logger(self, prefix, epoch, epoch_size=None):
        """register(key, value, dtype="scalar/loss", iteration=None) for
        `epoch`, with keys under `prefix`."""
        def register(key, value, dtype="scalar/loss", iteration=None):
            self.register_data(epoch, iteration, epoch_size,
                               f"{prefix}/{key}" if prefix else key, value,
                               dtype)
        return register

    def register_data(self, epoch, iteration, epoch_size, key, value, dtype):
        for s in self.streamers:
            s.register(epoch, iteration, epoch_size, key, value, dtype)
        if dtype.startswith("scalar"):
            if iteration is not None:
                self.iter_keys.add(key)
            self._epoch_acc[(key, dtype)].append(float(value))
        elif dtype.startswith("weight/"):
            data = value if isinstance(value, dict) else {"values": value}
            self._epoch_hists[key] = {
                sk: v if (isinstance(v, tuple) and len(v) == 2)
                else compute_histogram(v) for sk, v in data.items()}
        else:
            # blobs and heatmaps: the GAN paths' sample images, not ported
            raise NotImplementedError("event dtype %r is not ported yet"
                                      % dtype)

    def close_epoch(self, epoch):
        aggregated = {}
        for (key, dtype), values in self._epoch_acc.items():
            agg = self.AGGREGATIONS.get(dtype, "avg")
            # NaN iterations are dropped before aggregating
            vals = np.asarray(values, dtype=float)
            vals = vals[~np.isnan(vals)]
            aggregated[key] = float(np.sum(vals)) if agg == "sum" else (
                float(np.mean(vals)) if len(vals) else float("nan"))
            self.metadata.add(epoch, key, aggregated[key], dtype)
            # a scalar/time key's iterations make a histogram too
            if dtype == "scalar/time" and len(vals) > 1:
                self._epoch_hists.setdefault(key, {})["iterations"] = \
                    compute_histogram(vals, bins=min(50, len(vals)))
        self._epoch_acc.clear()
        for key, hists in self._epoch_hists.items():
            self.histograms[key][epoch] = hists
            if self.directory:
                with open(os.path.join(
                        self.directory, "epochs", "blobs", "%s_epoch_%02d.svg"
                        % (key.replace("/", "_"), epoch)), "w") as f:
                    f.write(_svg_histogram(hists))
        self._epoch_hists = {}
        self.metadata.note_epoch(epoch)
        for s in self.streamers:
            s.close_epoch(epoch)
        self.history.append({"epoch": epoch, "metrics": aggregated})
        if self.directory:
            with open(os.path.join(self.directory, "epochs", "events.json"),
                      "w") as f:
                json.dump(self.history, f, indent=1)
        return aggregated

    def state_dict(self):
        return {"history": self.history,
                "metadata": self.metadata.state_dict(),
                "iter_keys": sorted(self.iter_keys),
                "histograms": {
                    k: {e: {sk: (np.asarray(c).tolist(),
                                 np.asarray(n).tolist())
                            for sk, (c, n) in hs.items()}
                        for e, hs in v.items()}
                    for k, v in self.histograms.items()}}

    def load_state_dict(self, state):
        self.history = state["history"]
        self.iter_keys = set(state.get("iter_keys") or ())
        self.metadata.load_state_dict(state["metadata"])
        self.histograms = defaultdict(dict)
        for k, v in (state.get("histograms") or {}).items():
            for e, hs in v.items():
                self.histograms[k][int(e)] = {
                    sk: (np.asarray(c), np.asarray(n))
                    for sk, (c, n) in hs.items()}


def initialize_processor(params, directory=None, decisive_criterion=None):
    """An EventBroker from a reference-style output config ({progress:
    {print_each: ...}}). The HTML report and the TensorBoard writer are not
    ported yet: with a directory, asking for one raises."""
    params = dict(params or {})
    broker_type = params.pop("type", "EventBroker")
    if broker_type != "EventBroker":
        raise KeyError("Unsupported event broker type %r" % broker_type)
    params.pop("profile", None)  # the JAX package's jax.profiler option
    streamers = []
    if "progress" in params:
        prog = params.pop("progress")
        if not isinstance(prog, dict):  # the reference's scalar form
            prog = {"print_each": prog}
        # None stays None: the reference's "disabled" printer
        streamers.append(DebugPrinter(**{
            k: (int(v) if v is not None else None) for k, v in prog.items()}))
    for name in ("htmlreport", "tensorboard"):
        # without a directory the JAX package drops them too
        if name in params and directory:
            raise NotImplementedError("event processor %r is not ported yet"
                                      % name)
        params.pop(name, None)
    if params:  # unknown processors fail, as in the reference
        raise KeyError("Unsupported event processors: %s" % sorted(params))
    return EventBroker(directory=directory, streamers=streamers,
                       metadata=MetadataKeeper(decisive_criterion))
