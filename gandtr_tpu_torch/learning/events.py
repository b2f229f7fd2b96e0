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
"weight/grad", "blob" (an image in [0, 1] or uint8, saved as
`<key>_epoch_<ee>.jpg`, or text as `.txt`) and "heatmap" (maps in [0, 1]
saved as colormapped PNGs). Sinks get each closed epoch's history: the
`htmlreport` processor (learning/html_report.py) writes
`<dir>/epochs/htmlreport/index.html`. Host numpy only: the caller reads
values off the device.
"""
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

from gandtr_tpu_torch.parallel import mesh


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


def _colormap(arr, cmap):
    """Reds or coolwarm (uint8 RGB) of values clipped to [0, 1] (the
    reference plots them with vmin 0 and vmax 1)."""
    v = np.clip(np.asarray(arr, np.float64), 0.0, 1.0)
    if cmap == "reds":
        anchors = np.array([[255, 245, 240], [252, 146, 114], [103, 0, 13]],
                           np.float64)
    else:
        anchors = np.array([[59, 76, 192], [221, 221, 221], [180, 4, 38]],
                           np.float64)
    pos = v * (len(anchors) - 1)
    lo = np.clip(pos.astype(int), 0, len(anchors) - 2)
    frac = (pos - lo)[..., None]
    rgb = anchors[lo] * (1 - frac) + anchors[lo + 1] * frac
    return rgb.astype(np.uint8)


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


#: the reference's plots.py:29: percentile levels of the distribution fan
FAN_PERCENTILES = (0, 0.07, 0.16, 0.31, 0.5, 0.69, 0.84, 0.93, 1)


def _hist_percentiles(centers, counts, qs=FAN_PERCENTILES):
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total == 0 or not len(counts):
        return [0.0] * len(qs)
    idx = np.searchsorted(np.cumsum(counts), np.asarray(qs) * total)
    return [float(centers[min(i, len(counts) - 1)]) for i in idx]


def _svg_percentile_fan(epochs_hists, width=420, height=120):
    """{epoch: {subkey: (centers, counts)}} -> an SVG percentile fan over
    the epochs per subkey: nested bands between symmetric percentiles and
    the median line (the reference's plot_distribution, plots.py:28-68)."""
    eps = sorted(epochs_hists)
    subkeys = sorted({k for e in eps for k in epochs_hists[e]})
    panels, y0 = [], 0
    for subkey in subkeys:
        series = [_hist_percentiles(*epochs_hists[e][subkey])
                  if subkey in epochs_hists[e] else None for e in eps]
        pts = [(i, p) for i, p in enumerate(series) if p is not None]
        if not pts:
            continue
        flat = [v for _, p in pts for v in p]
        lo, hi = min(flat), max(flat)
        span = (hi - lo) or 1.0
        nx = max(len(eps) - 1, 1)

        def xy(i, v, y0=y0, lo=lo, span=span, nx=nx):
            return "%.1f,%.1f" % (10 + i * (width - 20) / nx,
                                  y0 + height - 14
                                  - (v - lo) * (height - 30) / span)

        nq = len(FAN_PERCENTILES)
        shapes = []
        for b in range(nq // 2):
            top = " ".join(xy(i, p[nq - 1 - b]) for i, p in pts)
            bot = " ".join(xy(i, p[b]) for i, p in reversed(pts))
            shapes.append('<polygon points="%s %s" fill="rgb(255,165,115)" '
                          'fill-opacity="0.25" stroke="none"/>' % (top, bot))
        median = " ".join(xy(i, p[nq // 2]) for i, p in pts)
        shapes.append('<polyline points="%s" fill="none" '
                      'stroke="rgb(226,115,70)" stroke-width="1.5"/>'
                      % median)
        panels.append('<g>%s<text x="12" y="%d" font-size="10">%s  '
                      '[%.3g, %.3g]</text></g>'
                      % ("".join(shapes), y0 + 12, subkey, lo, hi))
        y0 += height
    return ('<svg xmlns="http://www.w3.org/2000/svg" width="%d" height="%d" '
            'style="background:#fafafa">%s</svg>'
            % (width, y0, "".join(panels)))


class EventBroker:
    """Fans each event out to the streamers, aggregates per epoch and keeps
    the history (eventprocessor.py's broker). Arrays of weight/* events are
    not kept, only their histograms."""

    AGGREGATIONS = {"scalar/loss": "avg", "scalar/score": "avg",
                    "scalar/time": "sum"}

    def __init__(self, directory=None, streamers=(), metadata=None,
                 sinks=()):
        self.directory = directory
        self.streamers = list(streamers)
        self.sinks = list(sinks)
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
        elif dtype == "heatmap":
            self._save_heatmap(epoch, key, value)
        elif dtype == "blob":
            if self.directory is not None:
                self._save_blob(epoch, key, value)
        else:
            raise NotImplementedError("event dtype %r is not ported yet"
                                      % dtype)

    @staticmethod
    def _epoch_tag(epoch):
        """'%02d' of a training epoch; a validate stage's `None` is 'val'."""
        if isinstance(epoch, (int, np.integer)):
            return "%02d" % epoch
        return "val" if epoch is None else str(epoch)

    def _save_blob(self, epoch, key, value):
        from PIL import Image
        base = os.path.join(self.directory, "epochs", "blobs",
                            "%s_epoch_%s" % (key.replace("/", "_"),
                                             self._epoch_tag(epoch)))
        if isinstance(value, str):
            with open(base + ".txt", "w") as f:
                f.write(value)
            return
        arr = np.asarray(value)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(arr).save(base + ".jpg")

    def _save_heatmap(self, epoch, key, value):
        """2-D maps in [0, 1] as colormapped PNGs: Reds for a loss key,
        coolwarm otherwise (eventprocessor.py:228-244)."""
        if self.directory is None:
            return
        from PIL import Image
        data = value if isinstance(value, dict) else {"": value}
        for subkey, arr in data.items():
            cmap = "reds" if ("loss" in key or "loss" in subkey) \
                else "coolwarm"
            name = "_".join(x for x in (key.replace("/", "_"),
                                        subkey.replace("/", "_")) if x)
            Image.fromarray(_colormap(arr, cmap)).save(os.path.join(
                self.directory, "epochs", "blobs", "%s_epoch_%s.png"
                % (name, self._epoch_tag(epoch))))

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
        for sink in self.sinks:
            sink.close_epoch(epoch, history=self.history,
                             metadata=self.metadata,
                             histograms=self.histograms)
        return aggregated

    def ref_metadata(self):
        """Each loss's and each iteration-logged score's per-epoch series
        under the reference's metadata() key forms (eventprocessor.py:
        84-92, 119-120): `<section>/loss:<name>_avg.4` for a loss,
        `<key>_avg.4` for a score logged per iteration. A score logged
        once an epoch keeps its own key in the reference, so it is left
        out here: it stays a flat last-epoch value in the stage's
        `metrics`, and its series is in `metrics_series`."""
        out = {}
        for key, dtype in self.metadata.dtypes.items():
            if dtype == "scalar/loss":
                if ":" in key.rsplit("/", 1)[-1]:
                    base = key
                else:
                    head, _, name = key.rpartition("/")
                    base = "%s/loss:%s" % (head, name) if head \
                        else "loss:%s" % name
                out[base + "_avg.4"] = self.metadata.series(key)
            elif dtype == "scalar/score" and key in self.iter_keys:
                out[key + "_avg.4"] = self.metadata.series(key)
        return out

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
    {print_each: ...}, htmlreport: {}, tensorboard: {}}). With a
    directory, `htmlreport` adds the HTML report sink and `tensorboard`
    the event-file writer (learning/tensorboard.py). Without a directory
    both are dropped, as in the JAX package. Under a process group only
    rank 0 writes and prints: the other ranks keep the metadata alone."""
    params = dict(params or {})
    if not mesh.is_writer():
        directory = None
        params.pop("progress", None)
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
    sinks = []
    if "htmlreport" in params and directory:
        from gandtr_tpu_torch.learning.html_report import HtmlReport
        sinks.append(HtmlReport(directory))
    if "tensorboard" in params and directory:
        from gandtr_tpu_torch.learning.tensorboard import TensorboardWriter
        streamers.append(TensorboardWriter(directory))
    params.pop("htmlreport", None)
    params.pop("tensorboard", None)
    if params:  # unknown processors fail, as in the reference
        raise KeyError("Unsupported event processors: %s" % sorted(params))
    return EventBroker(directory=directory, streamers=streamers,
                       metadata=MetadataKeeper(decisive_criterion),
                       sinks=sinks)
