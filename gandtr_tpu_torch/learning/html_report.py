"""The HTML report sink (counterpart of gandtr_tpu/learning/html_report.py;
the reference's HtmlReport, eventprocessor.py:464-666): at every closed
epoch, `<dir>/epochs/htmlreport/index.html` with an inline-SVG curve per
metric (and one combined chart for a group of several), the weight
distributions (a histogram, or a percentile fan over two or more epochs)
and thumbnails of the blob images, the latest six epochs of each key.
"""
import html
import math
import os

_PALETTE = ("#06c", "#c30", "#293", "#a3c", "#c90", "#09a", "#666",
            "#e67", "#4bd", "#b52")


def _finite(values):
    return [v for v in values if math.isfinite(v)]


def _points(series, lo, span, width, height):
    """Polyline points; a non-finite value leaves a gap."""
    return " ".join(
        "%.1f,%.1f" % (10 + x * (width - 20) / max(len(series) - 1, 1),
                       height - 15 - (v - lo) * (height - 30) / span)
        for x, v in enumerate(series) if math.isfinite(v))


def _svg_curve(series, width=420, height=140, color="#06c"):
    finite = _finite(series)
    if not finite:
        return ""
    lo, hi = min(finite), max(finite)
    span = (hi - lo) or 1.0
    return ('<svg width="%d" height="%d" style="background:#fafafa;'
            'border:1px solid #ddd"><polyline fill="none" stroke="%s" '
            'stroke-width="1.5" points="%s"/><text x="12" y="12" '
            'font-size="10">max %.4g</text><text x="12" y="%d" '
            'font-size="10">min %.4g</text></svg>'
            % (width, height, color, _points(series, lo, span, width, height),
               hi, height - 4, lo))


def _svg_multi_curve(series_map, width=420, height=140):
    """Every series of one key group on one chart, with a legend."""
    allv = _finite(v for s in series_map.values() for v in s)
    if not allv:
        return ""
    lo, hi = min(allv), max(allv)
    span = (hi - lo) or 1.0
    parts = []
    for i, (name, series) in enumerate(sorted(series_map.items())):
        color = _PALETTE[i % len(_PALETTE)]
        parts.append('<polyline fill="none" stroke="%s" stroke-width="1.2" '
                     'points="%s"/>' % (color, _points(series, lo, span,
                                                       width, height)))
        parts.append('<text x="%d" y="%d" font-size="9" fill="%s">%s</text>'
                     % (12 + (i % 3) * 136, 12 + (i // 3) * 11, color,
                        html.escape(name)))
    return ('<svg width="%d" height="%d" style="background:#fafafa;'
            'border:1px solid #ddd">%s<text x="%d" y="%d" font-size="10">'
            '%.3g..%.3g</text></svg>'
            % (width, height, "".join(parts), width - 60, height - 4, lo, hi))


def _group_order(group):
    """The reference's section order (eventprocessor.py:574)."""
    order = {"train/learning": 0, "val/learning": 1, "train/net": 3,
             "net": 4, "train/data": 5}
    return order.get(group, 2 if "learning" in group else 100)


class HtmlReport:
    """A sink of events.EventBroker."""

    def __init__(self, directory):
        self.directory = directory
        self.report_dir = os.path.join(directory, "epochs", "htmlreport")
        os.makedirs(self.report_dir, exist_ok=True)

    def close_epoch(self, epoch, history=None, metadata=None,
                    histograms=None):
        if history is None:
            return
        rows = self._metrics(history)
        dists = self._distributions(histograms)
        thumbs = self._samples()
        doc = ("<!doctype html><html><head><meta charset=\"utf-8\">\n"
               "<title>gandtr-tpu report</title>\n"
               "<style>body{font-family:sans-serif;margin:20px}\n"
               ".metric{display:inline-block;margin:8px;vertical-align:top}\n"
               "figure{display:inline-block;margin:4px;text-align:center}\n"
               "figcaption{font-size:9px;max-width:128px;overflow:hidden}"
               "</style></head>\n<body><h1>Experiment report — epoch %s</h1>"
               "\n<h2>Metrics</h2>%s\n%s\n<h2>Samples</h2>%s\n</body></html>"
               % (epoch, "".join(rows), dists, thumbs))
        with open(os.path.join(self.report_dir, "index.html"), "w") as f:
            f.write(doc)

    @staticmethod
    def _metrics(history):
        groups = {}
        for key in sorted({k for h in history for k in h["metrics"]}):
            group = key.rpartition("/")[0] or key
            groups.setdefault(group, {})[key] = \
                [h["metrics"][key] for h in history if key in h["metrics"]]
        rows = []
        for group in sorted(groups, key=lambda g: (_group_order(g), g)):
            series_map = groups[group]
            if len(series_map) > 1:
                rows.append("<div class='metric'><h3>%s/* <small>combined"
                            "</small></h3>%s</div>"
                            % (html.escape(group),
                               _svg_multi_curve(series_map)))
            for key in sorted(series_map):
                series = series_map[key]
                rows.append("<div class='metric'><h3>%s <small>last %.5g"
                            "</small></h3>%s</div>"
                            % (html.escape(key), series[-1],
                               _svg_curve(series)))
        return rows

    @staticmethod
    def _distributions(histograms):
        if not histograms:
            return ""
        from gandtr_tpu_torch.learning.events import (_svg_histogram,
                                                      _svg_percentile_fan)
        blocks = []
        for key in sorted(histograms):
            epochs = histograms[key]
            if not epochs:
                continue
            last = max(epochs)
            svg = (_svg_percentile_fan(epochs) if len(epochs) > 1
                   else _svg_histogram(epochs[last]))
            blocks.append("<div class='metric'><h3>%s <small>epoch %d (%d "
                          "epochs)</small></h3>%s</div>"
                          % (html.escape(key), last, len(epochs), svg))
        return "<h2>Distributions</h2>" + "".join(blocks) if blocks else ""

    def _samples(self):
        blob_dir = os.path.join(self.directory, "epochs", "blobs")
        if not os.path.isdir(blob_dir):
            return ""
        groups = {}
        for n in sorted(os.listdir(blob_dir)):
            if not n.lower().endswith((".jpg", ".png", ".txt")):
                continue
            key, sep, ep = n.rsplit(".", 1)[0].rpartition("_epoch_")
            if not sep:
                key, ep = n, n
            groups.setdefault(key, []).append((ep, n))
        for items in groups.values():   # numeric epoch order
            items.sort(key=lambda t: (int(t[0]) if t[0].isdigit() else -1,
                                      t[0]))

        def fig(ep, n):
            cap = html.escape("epoch " + ep if ep != n else n)
            if n.lower().endswith(".txt"):
                return ("<figure><a href='../blobs/%s'>txt</a><figcaption>%s"
                        "</figcaption></figure>" % (html.escape(n), cap))
            return ("<figure><img src='../blobs/%s' width='128'><figcaption>"
                    "%s</figcaption></figure>" % (html.escape(n), cap))

        return "".join("<div class='metric'><h3>%s</h3>%s</div>"
                       % (html.escape(key),
                          "".join(fig(ep, n) for ep, n in groups[key][-6:]))
                       for key in sorted(groups))
