"""Serving a hub model (counterpart of gandtr_tpu/serving/export.py).

`Servable(model, image_hw)` is the in-memory form of the JAX package's
serving artifact, with the same `meta` keys: uint8 (N, H, W, 3) images in,
the device preprocessing (/255, CLAHE, normalize) inside the forward, and
requests padded up to a batch bucket and the outputs sliced (exact: every
step is per image). An embedding model answers (N, D) float32 descriptors;
a generator answers uint8 (N, H, W, 3) images, quantized on the device
(`device_quantize_rgb`). Serializing it (`torch.export`) is not ported yet.
"""
import numpy as np
import torch

from gandtr_tpu_torch.data.transforms import (device_quantize_rgb,
                                              split_device_transform)
from gandtr_tpu_torch.learning.wrappers import CirtorchWhiten
from gandtr_tpu_torch.models.generators import ResnetGenerator

FORMAT_VERSION = 1


def _artifact_kind(model):
    """'embedding' (descriptor nets: output (N, D)) or 'generator'
    (image to image: output (N, H, W, C)). Descriptor models carry a
    pooling entry in their meta."""
    return "embedding" if "pooling" in model.meta else "generator"


def _export_forward(model, kind):
    """(transforms, mean_std, forward) of a uint8-input model: forward((N,
    H, W, 3) uint8 tensor on the model's device) -> (N, D) descriptors, or
    uint8 (N, H, W, 3) images for a generator."""
    data_params = dict(model.net.data_params)
    mean_std = data_params["mean_std"]
    tf_str = data_params["transforms"]
    _, device_pre = split_device_transform(tf_str, mean_std)
    if device_pre is None:
        raise ValueError("serving needs a device-splittable transform "
                         "pipeline; got %r" % tf_str)
    ctx = {"msp": model.meta.get("msp", 1.0)}

    def forward(x):
        x = device_pre(x.to(torch.float32) / 255.0)
        y = model.net.apply(x, ctx=ctx)
        if kind == "generator":
            y = device_quantize_rgb(y, mean_std)
        return y

    return tf_str, mean_std, forward


def _descriptor_dim(model):
    for w in model.net.wrappers_eval:
        if isinstance(w, CirtorchWhiten):
            return int(w.dimensions)
    return int(model.meta["out_channels"])


def _output_shape(model, kind, h, w):
    if kind == "generator":
        return list(ResnetGenerator.output_hw(h, w)) + [
            int(model.meta["out_channels"])]
    return [_descriptor_dim(model)]


class Servable:
    """`servable(images)` on a numpy uint8 (N, H, W, 3) array -> numpy
    (N, D) float32 descriptors, or uint8 (N, H, W, 3) images for a
    generator, computed on `model.device`."""

    def __init__(self, model, image_hw, batch_buckets=(1, 4, 8)):
        kind = _artifact_kind(model)
        self.model = model
        self.device = model.device
        self.buckets = sorted(set(int(b) for b in batch_buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("batch buckets must be >= 1: %r" % batch_buckets)
        tf_str, mean_std, self._forward = _export_forward(model, kind)
        h, w = int(image_hw[0]), int(image_hw[1])
        self.meta = {
            "format_version": FORMAT_VERSION,
            "kind": kind,
            "image_hw": [h, w],
            "batch_buckets": list(self.buckets),
            "input_dtype": "uint8",
            "with_mask": False,
            "output_shape_per_item": _output_shape(model, kind, h, w),
            "transforms": tf_str,
            "mean_std": [list(map(float, mean_std[0])),
                         list(map(float, mean_std[1]))],
            "model_meta": {k: v for k, v in model.meta.items()
                           if isinstance(v, (int, float, str, bool))},
            "torch_version": torch.__version__,
            "device": str(self.device),
        }

    @torch.inference_mode()
    def _run_chunk(self, x):
        n = x.shape[0]
        bucket = next((b for b in self.buckets if b >= n), self.buckets[-1])
        if bucket > n:
            x = np.pad(x, [(0, bucket - n)] + [(0, 0)] * 3, mode="edge")
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self._forward(xt)[:n].cpu().numpy()

    def __call__(self, images):
        x = np.asarray(images)
        h, w = self.meta["image_hw"]
        if x.ndim == 3:
            x = x[None]
        if x.dtype != np.uint8 or x.shape[1:] != (h, w, 3):
            raise ValueError("input must be uint8 (N, %d, %d, 3), got %s %s"
                             % (h, w, x.dtype, x.shape))
        cap = self.buckets[-1]
        return np.concatenate([self._run_chunk(x[i:i + cap])
                               for i in range(0, x.shape[0], cap)], 0)
