"""Network wrappers (counterpart of gandtr_tpu/learning/wrappers.py): each
wrapper is a pair `pre(x, ctx) -> (x, meta)` / `post(y, ctx, meta) -> y`
composed around a model forward. NHWC batches in, (N, D) descriptors out.

Every wrapper of the JAX package's registry: the eval chain of the
descriptor nets (`cirmultiscale`, `cirwhiten`), the fine-tune chain of the
augment net (`meanstd_post`, `clahepost`, `cir_ratio_pass_through`,
`cirfaketuplebatch`), the HED detectors' input chain of HED^N-GAN
(`rgb2bgr_pre`, `meanstd_pre`), and `reflectpad_divisible`,
`random_pass_through` and `fakebatch`, in both forms configs write them
in: the string DSL and the sorted dict. The md5-name augmentation gate is
decided on the host per image name and reaches the batch as a boolean
`ctx["pass_mask"]` tensor; the selection is a `torch.where`.

In the padded-bucket mode (`ctx["mask_state"]`, ops/maskprop.py) ClahePost
computes each image's CLAHE on its valid rectangle, the whole batch in one
K4 launch on the card (the JAX package maps images one at a time,
`lax.map`, a compiler choice that does not carry over),
CirRatioPassThrough keeps each pass-through row's input rectangle, and
CirMultiscaleAggregation resizes each image's rectangle.
"""
import hashlib
import json
import os
import re

import numpy as np
import torch

from gandtr_tpu_torch.models.layers import pad2d
from gandtr_tpu_torch.ops import clahe as clahe_ops
from gandtr_tpu_torch.ops.maskprop import MaskState
from gandtr_tpu_torch.ops.resize import masked_scale_resize, scale_resize
from gandtr_tpu_torch.parallel import spatial


class ScaleList(list):
    """Marker: a wrapper expanded the input into per-scale batches; the model
    forward maps over it."""


class Wrapper:
    def pre(self, x, ctx):
        return x, None

    def post(self, y, ctx, meta):
        return y


class ReflectPadMakeDivisible(Wrapper):
    """Pad H and W up to a multiple of `divisible_by` (replicating the
    edge, the pad split top / bottom and left / right with the odd pixel
    after), crop the output back (wrapper.py:68-94)."""

    def __init__(self, divisible_by):
        self.divisible_by = int(divisible_by)

    def pre(self, x, ctx):
        spatial.refuse("reflectpad_divisible")
        d = self.divisible_by
        pady = -(x.shape[1] // -d) * d - x.shape[1]
        padx = -(x.shape[2] // -d) * d - x.shape[2]
        pad = (pady // 2, pady - pady // 2, padx // 2, padx - padx // 2)
        return pad2d(x, pad, "replicate"), pad

    def post(self, y, ctx, pad):
        t, b, l, r = pad
        return y[:, t:y.shape[1] - b or None, l:y.shape[2] - r or None, :]


class RandomPassThrough(Wrapper):
    """Each image takes the model's output with probability
    `probability_through`, else passes unchanged (wrapper.py:97-117). The
    model runs on the whole batch; the mask is `ctx["pass_mask"]` where
    given, else drawn from `ctx["generator"]` (a torch.Generator on the
    batch's device), one Bernoulli per image. The JAX package draws it
    with `jax.random.bernoulli`, another stream: the two agree on a given
    mask and in law."""

    def __init__(self, probability_through):
        self.probability = float(probability_through)

    def pre(self, x, ctx):
        return x, x

    def post(self, y, ctx, original):
        mask = ctx.get("pass_mask")
        if mask is None:
            mask = torch.rand(y.shape[0], generator=ctx["generator"],
                              device=y.device) < self.probability
        mask = torch.as_tensor(mask, device=y.device)
        return torch.where(mask[:, None, None, None], y, original.to(y.dtype))


class CirMultiscaleAggregation(Wrapper):
    """Run the model at each scale, p-power-mean the descriptors,
    renormalize. The power is ctx["msp"] (GeM p of a plain GeM net,
    `multiscale_msp`), and 1 for a single scale.

    In the padded-bucket mode `pre` resizes each image's valid rectangle
    (ops/resize.py::masked_scale_resize) and emits an (x, mask) pair per
    scale, which the model forward runs with that scale's mask. Under a
    row-sharded grid each scale is a band of the resized image, cut by the
    band plan of its height for the running net's total downsampling
    (ops/resize.py::scale_resize)."""

    SCALE_SETS = {"True": True, "False": False, "ms": True, "ss": False,
                  "sms5": [1, 1 / np.sqrt(2), np.sqrt(2), 1 / 2, 2],
                  "sms": [1, 1 / np.sqrt(2), np.sqrt(2)]}

    def __init__(self, scales=True):
        if isinstance(scales, str):
            scales = self.SCALE_SETS[scales]
        if isinstance(scales, bool):
            scales = [1, 1 / np.sqrt(2), 1 / 2] if scales else [1]
        self.scales = list(scales)

    def pre(self, x, ctx):
        st = ctx.get("mask_state")
        if st is not None and st.active:
            items = []
            for s in self.scales:
                xs, sts = (x, st) if s == 1 else masked_scale_resize(x, st, s)
                items.append((xs, sts.mask(xs.shape[1], xs.shape[2],
                                           torch.float32)))
            return ScaleList(items), None
        return ScaleList([scale_resize(x, s) if s != 1 else x
                          for s in self.scales]), None

    def post(self, descs, ctx, meta):
        """descs: list of (N, D) descriptor batches, one per scale."""
        msp = ctx.get("msp", 1.0) if len(self.scales) > 1 else 1.0
        v = sum(d ** msp for d in descs) / len(self.scales)
        v = v ** (1.0 / msp)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def multiscale_msp(model_cfg, module):
    """The multiscale power of the reference (wrapper.py:249-252): the GeM p
    of a plain GeM net (pooling gem, no whitening head in the model, not
    regional), else 1. An eval-time Lw wrapper does not change it. An
    edge-filter net (cirnet_inchan) aggregates with 1 too: the JAX
    package's test finds no top-level GeM p there (its p is under
    `net/`)."""
    model_cfg = dict(model_cfg or {})
    p = getattr(getattr(module, "pool", None), "p", None)
    if hasattr(module, "preprocessing"):
        p = None
    if (model_cfg.get("pooling", "gem") == "gem"
            and not model_cfg.get("whitening")
            and not model_cfg.get("regional")
            and p is not None):
        return float(p.detach().cpu()[0])
    return 1.0


class CirtorchWhiten(Wrapper):
    """Learned whitening: X = P[:d] (x - m), L2-normalized (with +1e-6, as
    the reference's whitenapply)."""

    def __init__(self, P, m, dimensions=None, device="cpu"):
        self.P = torch.as_tensor(np.asarray(P, np.float32), device=device)
        self.m = torch.as_tensor(np.asarray(m, np.float32),
                                 device=device).reshape(-1)
        self.dimensions = dimensions or self.P.shape[0]

    def post(self, y, ctx, meta):
        if self.P.device != y.device:   # built on the host by a net config
            self.P, self.m = self.P.to(y.device), self.m.to(y.device)
        X = (y - self.m[None, :]) @ self.P[:self.dimensions, :].T
        return X / (torch.linalg.vector_norm(X, dim=-1, keepdim=True) + 1e-6)


def _as_chan(v, device=None):
    """[c1, c2, c3] -> a (3,) float32 tensor (broadcasts over NHWC)."""
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _meanstd(v):
    return json.loads(v) if isinstance(v, str) else v


def metadata_name(path):
    """The name the reference hashes: the basename without its last
    extension (datahelpers.py:44); for a lazy h5 path `store.h5#cid` the
    per-image key."""
    if ".h5#" in path:
        path = path.split("#", 1)[1]
    return os.path.basename(path).rsplit(".", 1)[0]


def cir_hash_passthrough(name, probability):
    """The reference's deterministic md5 gate (wrapper.py:137-143): the last
    4 hex digits of md5(name) as a uniform sample, below `probability`."""
    rand = int(hashlib.md5(name.encode("utf8")).hexdigest()[-4:], 16) \
        / (16 ** 4)
    return rand < probability


class CirRatioPassThrough(Wrapper):
    """The GAN-augmentation switch (wrapper.py:120-146): an image takes the
    wrapped model's output only if its label matches and its name's hash
    falls under the ratio; `ctx["pass_mask"]` (N,) bool carries that per
    image, decided on the host (`cir_hash_passthrough`)."""

    def __init__(self, ratio_through, image_label):
        self.probability = float(ratio_through)
        self.image_label = re.compile(image_label)

    def pre(self, x, ctx):
        return x, x

    def post(self, y, ctx, original):
        mask = torch.as_tensor(ctx["pass_mask"], device=y.device)
        st = ctx.get("mask_state")
        if st is not None and st.active:
            # a pass-through row keeps its input rectangle, a model row the
            # model's output one
            st_in = ctx["mask_state_in"]
            ctx["mask_state"] = MaskState(tuple(
                torch.where(mask, a, b) for a, b in zip(st.hw, st_in.hw)))
        return torch.where(mask[:, None, None, None], y, original.to(y.dtype))


class FakeBatch(Wrapper):
    """Tuple flattening (wrapper.py:266-279): a (T, S, ...) batch becomes
    (T*S, ...) around the model and is restored after; a plain (N, H, W, C)
    batch passes through, as in the reference."""

    def pre(self, x, ctx):
        if x.dim() <= 4:
            return x, None
        return x.reshape((-1,) + tuple(x.shape[2:])), tuple(x.shape)

    def post(self, y, ctx, shape):
        if shape is None:
            return y
        return y.reshape(shape[:2] + tuple(y.shape[1:]))


class CirFakeTupleBatch(FakeBatch):
    """Tuple flattening with the descriptors back as (T, S, D) blocks
    (wrapper.py:282-305)."""


class MeanStdPost(Wrapper):
    """Distribution adaptation after the model (wrapper.py:149-190): from
    the input normalization to the output one."""

    def __init__(self, input_meanstd, output_meanstd):
        im, om = _meanstd(input_meanstd), _meanstd(output_meanstd)
        if any(v == 0 for v in np.atleast_1d(im[1])) or \
                any(v == 0 for v in np.atleast_1d(om[1])):
            raise ValueError(
                "Some std element is zero, leading to zero division.")
        self.im = [_as_chan(v) for v in im]
        self.om = [_as_chan(v) for v in om]
        self._on = None   # (device, the four tensors there)

    def _adapt(self, x):
        # the statistics are copied to the device once: a copy from host
        # memory each call would wait for the stream
        if self._on is None or self._on[0] != x.device:
            self._on = (x.device, [v.to(x.device) for v in self.im + self.om])
        im0, im1, om0, om1 = self._on[1]
        return (x * im1 + im0 - om0) / om1

    def post(self, y, ctx, meta):
        return self._adapt(y)


class MeanStdPre(MeanStdPost):
    """The same adaptation before the model (wrapper.py:193-204): the HED
    detectors' input from the generator's normalization to HED's."""

    def pre(self, x, ctx):
        return self._adapt(x), None

    def post(self, y, ctx, meta):
        return y


class RgbToBgrPre(Wrapper):
    """RGB -> BGR channel flip before the model (wrapper.py:351-364)."""

    def pre(self, x, ctx):
        return x.flip(-1), None


class ClahePost(Wrapper):
    """CLAHE between the generator and the descriptor net (wrapper.py:
    325-348): unnormalize to [0, 1], LAB CLAHE, normalize again. The
    reference goes to the CPU and cv2 one image at a time; here the batch
    stays on its device, with each image's own geometry in the masked
    mode."""

    def __init__(self, meanstd, clip_limit=4, grid_size=8, colorspace="lab"):
        self.meanstd = [_as_chan(v) for v in _meanstd(meanstd)]
        self.clip_limit = float(clip_limit)
        self.grid_size = int(grid_size)
        self.colorspace = colorspace

    def post(self, y, ctx, meta):
        mean, std = (v.to(y.device) for v in self.meanstd)
        y = y * std + mean
        st = ctx.get("mask_state")
        if st is not None and st.active:
            y = clahe_ops.image_clahe_masked(y, st.hw_tensor(),
                                             self.clip_limit, self.grid_size,
                                             self.colorspace)
        else:
            y = clahe_ops.image_clahe(y, self.clip_limit, self.grid_size,
                                      self.colorspace)
        return (y - mean) / std


WRAPPERS_LABELS = {
    "reflectpad_divisible": ReflectPadMakeDivisible,
    "random_pass_through": RandomPassThrough,
    "fakebatch": FakeBatch,
    "cirfaketuplebatch": CirFakeTupleBatch,
    "cir_ratio_pass_through": CirRatioPassThrough,
    "meanstd_post": MeanStdPost,
    "meanstd_pre": MeanStdPre,
    "rgb2bgr_pre": RgbToBgrPre,
    "cirmultiscale": CirMultiscaleAggregation,
    "cirwhiten": CirtorchWhiten,
    "clahepost": ClahePost,
}


def _split(s, sep):
    """Split at `sep` outside brackets (the reference's utils.py:95-112)."""
    parts, depth, cur = [], 0, ""
    for ch in s:
        if ch in "[({":
            depth += 1
        elif ch in "])}":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def split_wrapper_string(s):
    """`name:arg:arg,name2:...` -> one string per wrapper."""
    return [p for p in _split(s, ",") if p]


def _split_args(wrap):
    """`name:arg:arg` -> [name, arg, arg], bracket-aware."""
    return _split(wrap, ":")


def initialize_wrappers(net_wrappers):
    """A wrapper string (`name:arg:arg,name2:...`) or a dict of keyword
    arguments keyed `<order>_<name>` (run in sorted key order, as configs
    write `0_cirwhiten`, `1_cirmultiscale`) -> a list of wrappers
    (wrapper.py:384-396)."""
    if isinstance(net_wrappers, dict):
        return [WRAPPERS_LABELS[k.split("_", 1)[1]](
                    **(net_wrappers[k] or {})) for k in sorted(net_wrappers)]
    wraps = []
    for wrap in [x.strip() for x in split_wrapper_string(net_wrappers or "")
                 if x.strip()]:
        wname, *args = _split_args(wrap)
        wraps.append(WRAPPERS_LABELS[wname](*args))
    return wraps


def apply_wrapped(wrappers, forward, x, ctx=None):
    """Compose pre/post around a forward; a ScaleList from a `pre` maps the
    forward over its items."""
    ctx = ctx or {}
    metas = []
    for w in wrappers:
        x, meta = w.pre(x, ctx)
        metas.append(meta)
    if isinstance(x, ScaleList):
        y = [forward(xi) for xi in x]
    else:
        y = forward(x)
    for w, meta in reversed(list(zip(wrappers, metas))):
        y = w.post(y, ctx, meta)
    return y
