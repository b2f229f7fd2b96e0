"""Serving artifacts of hub models (counterpart of
gandtr_tpu/serving/export.py).

`export_hub_model` traces a model's serving forward (uint8 images in, the
device preprocessing, /255, CLAHE and normalize, inside; the weights baked
in) with `torch.export` and writes it as a directory:

    meta.json   the JAX package's keys (kind, input spec, batch buckets,
                transform provenance), with `torch_version` and `device`
                (the device type the program was exported for) where it
                has `jax_version`
    b<N>.pt2    one exported program a batch bucket

A request batch is padded up to the next bucket and the outputs sliced;
that is exact, since every serving graph works image by image (instance
norm, GeM, CLAHE), and a fixed shape a bucket keeps the programs free of
symbolic sizes. K1 and K3 are custom operators (ops/library.py), so an
exported program calls the kernels on the card and the plain versions on
the CPU, and the kernels' launch counts see the calls.

`export_sharded_model` writes the data-parallel form, the JAX package's
SPMD artifact: one program at `batch_per_device` rows, with meta
`sharded: {n_devices, axis, batch_per_device}`; a loaded one needs exactly
`n_devices` devices and runs each request batch split over them in row
order, each share on its own device and stream, and the outputs
concatenated.

`Servable(model, image_hw)` is the same forward in memory, the form an
exported program is checked against; `load_artifact(path)` loads a
directory into an `ArtifactServable`, which with `devices=[...]` sends an
unsharded artifact's request chunks round-robin to them. Both take numpy
(N, H, W, 3) images of the artifact's input dtype (and with `with_mask`,
(N, H, W) masks) and return numpy: (N, D) float32 descriptors, or uint8 (N, H, W, 3) images
for a generator (quantized on the device), or with `from_uint8=False`
its normalized float32 output.
"""
import contextlib
import glob
import json
import os

import numpy as np
import torch

from gandtr_tpu_torch.data.transforms import (device_quantize_rgb,
                                              split_device_transform)
from gandtr_tpu_torch.device import resolve_device, upload
from gandtr_tpu_torch.ops import library  # noqa: F401  (registers the ops)

FORMAT_VERSION = 1


def _artifact_kind(model):
    """'embedding' (descriptor nets: output (N, D)) or 'generator'
    (image to image: output (N, H, W, C)). Descriptor models carry a
    pooling entry in their meta."""
    return "embedding" if "pooling" in model.meta else "generator"


def _export_forward(model, from_uint8, kind, with_mask=False):
    """(transforms, mean_std, forward): the one definition of an artifact's
    provenance and forward body, in memory and exported. forward(x[,
    mask]) takes a (N, H, W, 3) tensor on the model's device: uint8 with
    `from_uint8` (the device preprocessing runs inside; a generator's
    output is quantized to uint8 there too), else the normalized float32
    batch."""
    data_params = dict(getattr(model.net, "data_params", None) or {})
    mean_std = data_params.get("mean_std", [[0.5] * 3, [0.5] * 3])
    tf_str = data_params.get("transforms", "pil2np | totensor | normalize")
    device_pre = None
    if from_uint8:
        _, device_pre = split_device_transform(tf_str, mean_std)
        if device_pre is None:
            raise ValueError(
                "from_uint8=True needs a device-splittable transform "
                "pipeline; got %r" % tf_str)
    ctx = {"msp": model.meta.get("msp", 1.0)}

    def forward(x, *extra):
        if from_uint8:
            x = device_pre(x.to(torch.float32) / 255.0)
        kw = {"mask": extra[0]} if with_mask else {}
        y = model.net.apply(x, ctx=ctx, **kw)
        if kind == "generator":
            y = device_quantize_rgb(y, mean_std) if from_uint8 else y.float()
        return y

    return tf_str, mean_std, forward


def _check_mask(model, kind, with_mask):
    """JAX's refusals: a mask only for an embedding model without eval
    wrappers (they do not thread masks)."""
    if not with_mask:
        return
    if kind != "embedding":
        raise ValueError("with_mask only applies to embedding models")
    if model.net.wrappers_eval:
        raise ValueError(
            "with_mask requires an eval-wrapper-free net (wrappers "
            "don't thread masks); got %r" % model.net.wrappers_eval)


def _buckets(batch_buckets):
    buckets = sorted(set(int(b) for b in batch_buckets))
    if not buckets or buckets[0] < 1:
        raise ValueError("batch buckets must be >= 1: %r" % (batch_buckets,))
    return buckets


def _base_meta(model, kind, hw, buckets, from_uint8, with_mask, out_spec,
               tf_str, mean_std, device):
    return {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "image_hw": [int(hw[0]), int(hw[1])],
        "batch_buckets": list(buckets),
        "input_dtype": "uint8" if from_uint8 else "float32",
        "with_mask": bool(with_mask),
        "output_shape_per_item": out_spec,
        "transforms": tf_str,
        "mean_std": [list(map(float, mean_std[0])),
                     list(map(float, mean_std[1]))],
        "model_meta": {k: v for k, v in model.meta.items()
                       if isinstance(v, (int, float, str, bool))},
        "torch_version": torch.__version__,
        "device": torch.device(device).type,
    }


class _Program(torch.nn.Module):
    """The serving forward as a module for `torch.export`: it holds the
    module the forward runs (the net's compute-dtype copy, or the net's
    own module), so the weights export as the program's parameters."""

    def __init__(self, model, forward):
        super().__init__()
        self.net = model.net.compute_module()
        self._forward = forward

    def forward(self, x, *extra):
        return self._forward(x, *extra)


def _example_inputs(b, h, w, from_uint8, with_mask, device):
    x = torch.zeros((b, h, w, 3), dtype=torch.uint8 if from_uint8
                    else torch.float32, device=device)
    return (x, torch.ones((b, h, w), device=device)) if with_mask else (x,)


def export_hub_model(model, path, image_hw, batch_buckets=(1, 4, 8),
                     from_uint8=True, with_mask=False, platforms=None,
                     kind=None):
    """Export a hub model (`.net`, `.meta`, `.device`; its net's
    `data_params` give the transforms) into a serving artifact directory at
    `path`, for the device type the model lives on. Returns the meta.

    - `image_hw`: the fixed (H, W) the programs take.
    - `batch_buckets`: the batch sizes exported; a request pads up to the
      next bucket.
    - `from_uint8`: the device preprocessing inside (uint8 RGB input); a
      generator also quantizes its output to uint8 inside. With False the
      program takes the normalized float32 batch.
    - `with_mask`: a (N, H, W) float32 valid-pixel input for aspect-
      preserving serving through masked GeM; an embedding model without
      eval wrappers only. CLAHE runs static over the padded image, as in
      the JAX package.
    - `platforms`: the JAX package's list of target platforms; here it may
      only name the model's device type."""
    kind = kind or _artifact_kind(model)
    dev = torch.device(model.device)
    if platforms is not None and list(platforms) != [dev.type]:
        raise ValueError("an artifact runs on the device type its model "
                         "lives on (%s); platforms=%r" % (dev.type,
                                                          platforms))
    h, w = int(image_hw[0]), int(image_hw[1])
    buckets = _buckets(batch_buckets)
    _check_mask(model, kind, with_mask)
    tf_str, mean_std, forward = _export_forward(model, from_uint8, kind,
                                                with_mask=with_mask)
    program = _Program(model, forward)
    os.makedirs(path, exist_ok=True)
    out_spec = None
    for b in buckets:
        with torch.no_grad():
            ep = torch.export.export(
                program, _example_inputs(b, h, w, from_uint8, with_mask,
                                         dev), strict=False)
        out_node = next(n for n in ep.graph.nodes if n.op == "output")
        out_spec = list(out_node.args[0][0].meta["val"].shape[1:])
        torch.export.save(ep, os.path.join(path, "b%d.pt2" % b))
    meta = _base_meta(model, kind, (h, w), buckets, from_uint8, with_mask,
                      out_spec, tf_str, mean_std, dev)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return meta


def export_sharded_model(model, path, image_hw, n_devices,
                         batch_per_device=1, from_uint8=True, axis="data",
                         devices=None, platforms=None, kind=None):
    """Export the data-parallel serving artifact of a hub model: one
    program at `batch_per_device` rows (b<batch_per_device>.pt2), which a
    loaded artifact runs on each of exactly `n_devices` devices, each on
    its share of a request batch of n_devices x batch_per_device rows. The
    JAX package's SPMD program becomes a program a device here; the meta
    records `sharded: {n_devices, axis, batch_per_device}` as JAX's does.
    `devices`, when given, must hold at least `n_devices` devices (the
    JAX package's check); the program is exported on the model's device.
    Returns the meta."""
    kind = kind or _artifact_kind(model)
    dev = torch.device(model.device)
    if platforms is not None and list(platforms) != [dev.type]:
        raise ValueError("an artifact runs on the device type its model "
                         "lives on (%s); platforms=%r" % (dev.type,
                                                          platforms))
    if devices is not None and len(devices) < n_devices:
        raise ValueError("export_sharded_model needs %d devices, have %d"
                         % (n_devices, len(devices)))
    h, w = int(image_hw[0]), int(image_hw[1])
    bpd = int(batch_per_device)
    tf_str, mean_std, forward = _export_forward(model, from_uint8, kind)
    os.makedirs(path, exist_ok=True)
    with torch.no_grad():
        ep = torch.export.export(
            _Program(model, forward),
            _example_inputs(bpd, h, w, from_uint8, False, dev), strict=False)
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    torch.export.save(ep, os.path.join(path, "b%d.pt2" % bpd))
    meta = _base_meta(model, kind, (h, w), [int(n_devices) * bpd],
                      from_uint8, False,
                      list(out_node.args[0][0].meta["val"].shape[1:]),
                      tf_str, mean_std, dev)
    meta["sharded"] = {"n_devices": int(n_devices), "axis": axis,
                       "batch_per_device": bpd}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return meta


def _pad_rows(a, rows):
    if a is None or a.shape[0] == rows:
        return a
    return np.pad(a, [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1),
                  mode="edge")


class _Bucketed:
    """Pads and chunks as the JAX package's Servable: requests above the
    largest bucket are cut into chunks of it, a partial chunk is padded
    (edge rows) up to the next bucket and the outputs sliced. A subclass
    gives `meta`, `device`, `buckets` and `_program(bucket, device)`; and
    may give `devices` (chunks round-robin over them) and `sharded` (each
    chunk split over the devices, each share on its own stream)."""

    devices = None
    sharded = None
    streams = None

    def _launch(self, program, args, k):
        """Run `program` on its device's k-th stream (the current one on
        the CPU or without streams); the output stays on the device."""
        stream = self.streams[k] if self.streams else None
        if stream is not None:
            # the inputs were uploaded on the device's current stream
            stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.inference_mode(), (torch.cuda.stream(stream)
                                      if stream is not None
                                      else contextlib.nullcontext()):
            return program(*args)

    def _run_chunk(self, x, mask, k=0):
        n = x.shape[0]
        bucket = next((b for b in self.buckets if b >= n), self.buckets[-1])
        device = self.devices[k] if self.devices else self.device
        x, mask = _pad_rows(x, bucket), _pad_rows(mask, bucket)
        args = [upload(x, device)]
        if mask is not None:
            args.append(upload(mask, device))
        if not self.sharded:
            return self._launch(self._program(bucket, device), args, k)[:n]
        # one share a device, in row order
        per = self.sharded["batch_per_device"]
        outs = [self._launch(self._program(per, d),
                             [a[i * per:(i + 1) * per] for a in args], i)
                for i, d in enumerate(self.devices)]
        for s in self.streams or ():
            s.synchronize()
        return torch.cat([o.cpu() for o in outs])[:n]

    def __call__(self, images, masks=None):
        x = np.asarray(images)
        h, w = self.meta["image_hw"]
        if x.ndim == 3:
            x = x[None]
        dtype = np.dtype(self.meta["input_dtype"])
        if x.dtype != dtype or x.shape[1:] != (h, w, 3):
            raise ValueError("input must be %s (N, %d, %d, 3), got %s %s"
                             % (dtype, h, w, x.dtype, x.shape))
        if self.meta["with_mask"]:
            if masks is None:
                masks = np.ones(x.shape[:3], np.float32)
            else:
                masks = np.asarray(masks, np.float32)
                if masks.ndim == 2:  # one image, as x = x[None]
                    masks = masks[None]
        elif masks is not None:
            raise ValueError("artifact was exported without mask input")
        cap = self.buckets[-1]
        rr = len(self.devices) if self.devices and not self.sharded else 1
        outs = [self._run_chunk(x[i:i + cap],
                                None if masks is None else masks[i:i + cap],
                                c % rr)
                for c, i in enumerate(range(0, x.shape[0], cap))]
        for s in self.streams or ():
            s.synchronize()
        return np.concatenate([o.cpu().numpy() for o in outs], 0)


class Servable(_Bucketed):
    """A hub model's serving forward in memory, on `model.device`, with the
    meta an exported artifact of it would carry."""

    def __init__(self, model, image_hw, batch_buckets=(1, 4, 8),
                 from_uint8=True, with_mask=False, kind=None):
        kind = kind or _artifact_kind(model)
        _check_mask(model, kind, with_mask)
        self.model = model
        self.device = torch.device(model.device)
        self.buckets = _buckets(batch_buckets)
        tf_str, mean_std, self._forward = _export_forward(
            model, from_uint8, kind, with_mask=with_mask)
        h, w = int(image_hw[0]), int(image_hw[1])
        self.meta = _base_meta(model, kind, (h, w), self.buckets, from_uint8,
                               with_mask, _output_shape(model, kind, h, w),
                               tf_str, mean_std, self.device)

    def _program(self, bucket, device=None):
        return self._forward


def _output_shape(model, kind, h, w):
    """The per-item output shape, from the net's own sizes."""
    if kind == "generator":
        from gandtr_tpu_torch.models.generators import ResnetGenerator
        return list(ResnetGenerator.output_hw(h, w)) + [
            int(model.meta["out_channels"])]
    from gandtr_tpu_torch.learning.wrappers import CirtorchWhiten
    for wr in model.net.wrappers_eval:
        if isinstance(wr, CirtorchWhiten):
            return [int(wr.dimensions)]
    return [int(model.meta["out_channels"])]


class ArtifactServable(_Bucketed):
    """A loaded serving artifact (the JAX package's `Servable`): each
    bucket's exported program is loaded at its first call, once a device.

    `devices`: an unsharded artifact's request chunks go round-robin to
    them; a sharded one needs exactly its `n_devices` (by default the
    first cards of `device`'s type), and each gets its own stream."""

    def __init__(self, path, device=None, devices=None):
        self.device = resolve_device(device if device is not None or
                                     not devices else devices[0])
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if glob.glob(os.path.join(path, "b*.jaxexp")) or (
                "jax_version" in self.meta
                and "torch_version" not in self.meta):
            raise ValueError(
                "%s is an artifact of the JAX package (b<N>.jaxexp); this "
                "package loads torch.export programs (b<N>.pt2): export the "
                "model with gandtr_tpu_torch.serving.export_hub_model" % path)
        if self.meta.get("format_version") != FORMAT_VERSION:
            raise ValueError("Unsupported artifact format_version %r"
                             % self.meta.get("format_version"))
        self.sharded = self.meta.get("sharded")
        self.devices = [resolve_device(d) for d in devices] if devices \
            else None
        if self.sharded:
            n = self.sharded["n_devices"]
            if self.devices is None:
                self.devices = ([torch.device("cuda", i) for i in range(
                    min(n, torch.cuda.device_count()))]
                    if self.device.type == "cuda" else [self.device] * n)
            if len(self.devices) != n:
                raise ValueError(
                    "sharded artifact needs exactly %d devices, got %d"
                    % (n, len(self.devices)))
        for d in self.devices or [self.device]:
            if self.meta["device"] != d.type:
                raise ValueError(
                    "artifact %s was exported for %s and cannot run on %s: "
                    "export it again from a model on %s"
                    % (path, self.meta["device"], d.type, d.type))
        if self.devices and self.devices[0].type == "cuda":
            self.streams = [torch.cuda.Stream(d) for d in self.devices]
        self.path = path
        self.buckets = list(self.meta["batch_buckets"])
        self._programs = {}

    def _program(self, bucket, device=None):
        """Bucket `bucket`'s program on `device` ({bucket: {device:
        program}})."""
        device = self.device if device is None else device
        on = self._programs.setdefault(bucket, {})
        if str(device) not in on:
            ep = torch.export.load(os.path.join(self.path,
                                                "b%d.pt2" % bucket))
            on[str(device)] = ep.module().to(device)
        return on[str(device)]


def load_artifact(path, device=None, devices=None):
    """Load an artifact directory to run on `device` (cuda by default),
    or over `devices`, of the device type it was exported for."""
    return ArtifactServable(path, device=device, devices=devices)
