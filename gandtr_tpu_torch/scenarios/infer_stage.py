"""The infer stage and the network loader of the scenario stages
(counterpart of gandtr_tpu/scenarios/infer_stage.py; the reference's
stages/infer.py and data/output.py).

    (meta,) = infer(params, (names,))                  # on cuda
    meta["vecs"]     # embedding output: (D, N) float32, in `names` order
    meta["count"]    # image output: the images written
    infer_incrementally(params, (ids, values, new_ids))  # only the new ones

The `embedding` output runs the images through the validate stage's
extractor (with `data.shape_bucket`, padded buckets and masked CLAHE, K4
on the card; without it exact shapes and K1). The `image` output (the
`output` target, parameters/output_gan.yml) runs same-shape batches
through a generator in eval mode, optionally through a named method with
extra arguments (the `forward` section), and writes each output as an
image file through `RgbImageSaver`; `data.device_postprocess: true`
quantizes a plain RGB output to uint8 on the device first
(`device_quantize_rgb`). `data` takes the flat form
{image_dir, image_size, transforms, mean_std, loader, ...} or the
reference's nested `data.test.{dataset: {name: CirImageList, image_dir,
image_size}, loader, ...}`.
"""
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from gandtr_tpu_torch.data.cir_datasets import imresize
from gandtr_tpu_torch.data.datasets import imread, path_join
from gandtr_tpu_torch.data.transforms import (device_quantize_rgb,
                                              initialize_transforms,
                                              seed_transforms,
                                              split_device_transform)
from gandtr_tpu_torch.device import resolve_device, upload
from gandtr_tpu_torch.eval.retrieval import _prefetched, extract_vectors
from gandtr_tpu_torch.hub import (_checkpoint_data_params,
                                  _checkpoint_model_state,
                                  _checkpoint_net_state, _init_random)
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.learning.wrappers import apply_wrapped
from gandtr_tpu_torch.ops import colorspace as cs
from gandtr_tpu_torch.parallel import mesh
from gandtr_tpu_torch.utils.io import resolve_path

GAN_MEAN_STD = [[0.5] * 3, [0.5] * 3]


class RgbImageSaver:
    """Denormalize and write each output image (the reference's
    output.py:29-115), on a pool of writer threads.

    Names: `structure="flat"` joins a multi-piece name with "::" (every
    piece but the last without its extension) and turns "/" into "%";
    `"input"` keeps the relative path (a multi-piece name its first
    piece). By default a plain name is "input" and a multi-piece one
    "flat", row by row. With `append`, names whose file exists are left
    out (`exclude_existing`).

    `stretch_by` (imgtools.py:20-29): "meanstd" denormalizes with the
    mean and std, in float64 as the reference's python lists promote
    (which keeps its truncation ties); "auto" stretches min to max;
    "none" writes the raw values; a number n denormalizes, divides by n
    and adds 1/(2n).

    `transforms` is the dataset's transform string; as the reference's
    imgtools (imgtools.py:5-11, 31-60), the saver reads markers in it and
    undoes them:
    - `tolab`, `toluv`, `tolsh`: denormalize, clip each channel to the
      space's range, convert to RGB (lab and luv saturate there, as cv2);
      stretch_by is ignored, as in the reference. With `chan1` the output
      is one channel, padded with zeros to three and written as the mean
      of the RGB result (grayscale).
    - `tospace:X` (the live transform, normalized values): denormalize,
      convert back with ops/colorspace.py::normspace2rgb, clip to [0, 1].
    - `chan42` and `add_meanstd` take the network's input too
      (`needs_input`): chan42 writes the input's channels after the third
      before the output's, add_meanstd the output's first channel.

    `close()` waits for every write and re-raises the first error."""

    WRITERS = 6     # threads encoding and writing the files

    def __init__(self, directory, mean_std, structure=None, append=False,
                 stretch_by="meanstd", transforms=""):
        self.transforms = transforms or ""
        self.directory = resolve_path(directory)
        self.mean = np.asarray(mean_std[0], np.float64)
        self.std = np.asarray(mean_std[1], np.float64)
        self.structure = structure
        self.append = append
        self.stretch_by = stretch_by
        self.colorspace = next((c for c in ("lab", "luv", "lsh")
                                if "to" + c in self.transforms), None)
        self.normspace = None
        for piece in self.transforms.split("|"):
            piece = piece.strip()
            if piece.startswith("tospace:"):
                self.normspace = piece.split(":", 1)[1].strip()
        os.makedirs(self.directory, exist_ok=True)
        self.pool = ThreadPoolExecutor(self.WRITERS)
        self.futures = []

    @staticmethod
    def flat_name(name):
        if isinstance(name, (list, tuple)):
            name = "::".join([x.rsplit(".", 1)[0] for x in name[:-1]]
                             + [name[-1]])
        return name.replace("/", "%")

    def target_path(self, name):
        structure = self.structure
        if structure is None:
            structure = "flat" if isinstance(name, (list, tuple)) else "input"
        if structure == "flat":
            name = self.flat_name(name)
        elif isinstance(name, (list, tuple)):
            name = name[0]
        path = os.path.join(self.directory, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def exclude_existing(self, names):
        if not self.append:
            return names
        return [n for n in names if not os.path.exists(self.target_path(n))]

    @property
    def needs_input(self):
        """chan42 and add_meanstd mix the (normalized) input into the
        written image (imgtools.get_image, imgtools.py:63-71)."""
        return "chan42" in self.transforms or "add_meanstd" in self.transforms

    def to_uint8(self, arr):
        """(H, W, C) float output -> the uint8 image written."""
        if self.colorspace:
            return self._colorspace_to_uint8(arr)
        if self.normspace and self.normspace not in ("rgb", "gray"):
            return self._normspace_to_uint8(arr)
        img = np.asarray(arr, np.float32)
        if img.shape[-1] == 1:
            img = img[..., 0]
        elif img.shape[-1] > 3:
            img = img[..., :3]
        s = self.stretch_by
        c = 1 if img.ndim == 2 else img.shape[-1]
        if s == "auto":
            img = img - np.min(img)
            img = img / np.max(img)
        elif s == "meanstd":
            img = img * self.std[:c] + self.mean[:c]
        elif s != "none":
            img = img * self.std[:c] + self.mean[:c]
            img = img / float(s)
            img = img + 1.0 / 2.0 / float(s)
        return np.clip(img * 255, 0, 255).astype(np.uint8)

    def _normspace_to_uint8(self, arr):
        img = np.asarray(arr, np.float32)
        c = min(img.shape[-1], 3)
        img = img[..., :3] * self.std[:c] + self.mean[:c]
        rgb = cs.normspace2rgb(torch.from_numpy(img.astype(np.float32)),
                               self.normspace).numpy()
        return (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)

    def _colorspace_to_uint8(self, arr):
        """imgtools.py:31-60. The final cast does not clip, as there: lab
        and luv saturate, and a clipped lsh gives RGB in range."""
        img = np.asarray(arr, np.float32)
        mean, std = self.mean, self.std
        chan1 = "chan1" in self.transforms
        if chan1:
            img = np.concatenate([img, np.zeros_like(img),
                                  np.zeros_like(img)], axis=-1)
            mean = np.array([mean[0], 0.0, 0.0])
            std = np.array([std[0], 1.0, 1.0])
        img = img[..., :3] * std[:3] + mean[:3]
        if self.colorspace == "lab":
            img[..., 0] = np.clip(img[..., 0], 0, 100)
            img[..., 1:] = np.clip(img[..., 1:], -127, 127)
        elif self.colorspace == "luv":
            img[..., 0] = np.clip(img[..., 0], 0, 100)
            img[..., 1] = np.clip(img[..., 1], -134, 220)
            img[..., 2] = np.clip(img[..., 2], -140, 122)
        else:   # lsh: [l, s, h] -> HLS [h, l, s]
            img = np.stack([np.clip(img[..., 2], 0, 360),
                            np.clip(img[..., 0], 0, 1),
                            np.clip(img[..., 1], 0, 1)], axis=-1)
        convert = {"lab": cs.lab_to_rgb, "luv": cs.luv_to_rgb,
                   "lsh": cs.hls_to_rgb}[self.colorspace]
        rgb = convert(torch.from_numpy(img.astype(np.float32)))
        if self.colorspace in ("lab", "luv"):
            rgb = rgb.clamp(0.0, 1.0)   # cv2 saturates LAB2RGB / LUV2RGB
        rgb = rgb.numpy()
        if chan1:
            rgb = np.mean(rgb, axis=-1)
        return (rgb * 255).astype(np.uint8)

    def add(self, name, image_hwc, input_hwc=None):
        """Queue the write of one (H, W, C) output: a float one is turned
        into uint8 here, a uint8 one (quantized on the device) is written
        as it is. `input_hwc` is the network's input, for the sinks that
        need it. Under a process group only rank 0 writes."""
        if not mesh.is_writer():
            return
        out = np.asarray(image_hwc)
        if input_hwc is not None:
            if "chan42" in self.transforms:
                out = np.concatenate([np.asarray(input_hwc)[..., 3:], out],
                                     axis=-1)
            elif "add_meanstd" in self.transforms:
                out = out[..., :1]

        def write(arr):
            if arr.dtype != np.uint8:
                arr = self.to_uint8(arr)
            elif arr.ndim == 3 and arr.shape[-1] == 1:
                arr = arr[..., 0]
            Image.fromarray(arr).save(self.target_path(name))
        self.futures.append(self.pool.submit(write, out))

    def close(self):
        try:
            for f in self.futures:
                f.result()
        finally:
            self.pool.shutdown()


def _flat_data(data_cfg):
    """The flat data section of either form; the nested form takes only
    the reference's CirImageList dataset."""
    data_cfg = dict(data_cfg or {})
    if isinstance(data_cfg.get("test"), dict):
        nested = dict(data_cfg["test"])
        ds = dict(nested.pop("dataset", None) or {})
        name = ds.pop("name", None)
        if name not in (None, "CirImageList"):
            raise NotImplementedError("infer dataset %r" % name)
        data_cfg = {**nested, **ds}
    return data_cfg


def infer(params, data, device=None):
    """params: {network: {path | model, runtime}, data: {image_dir,
    image_size, shape_bucket, transforms, mean_std, loader} (or the nested
    form), output: {type: image | embedding, ...}, forward: {method,
    params}}; data[0]: the image names, joined to `data.image_dir` as the
    reference's path_join does. The embedding output returns ({"count",
    "vecs" (D, N) in name order, "names"},), the image output
    ({"count"},), the count of images run (an `append` output leaves out
    those already written). Runs on cuda unless `device="cpu"`."""
    dev = resolve_device(device)
    # the stage's fixed seed, as the reference's (stages/infer.py:20-21)
    np.random.seed(0)
    seed_transforms(0)
    params = dict(params)
    names = list(data[0]) if data else []
    out_cfg = dict(params.pop("output", None) or {})
    out_type = out_cfg.pop("type", "image")
    data_cfg = _flat_data(params.pop("data", None))
    if out_type == "image":
        return _infer_images(params, data_cfg, out_cfg, names, dev)
    if out_type != "embedding":
        raise ValueError("infer output type %r" % out_type)
    if params.get("forward"):
        raise NotImplementedError("infer's `forward` section takes an image "
                                  "output only")
    # validate_stage imports this module for _load_network
    from gandtr_tpu_torch.scenarios.validate_stage import build_eval
    setup = build_eval({"network": params["network"], "data": data_cfg},
                       dev)
    image_dir = resolve_path(data_cfg.get("image_dir", ""))
    paths = [path_join(image_dir, n) for n in names]
    image_size = data_cfg.get("image_size")
    batch_size = int((data_cfg.get("loader") or {}).get("batch_size", 8))
    vecs = extract_vectors(setup["extractor"], paths,
                           int(image_size) if image_size else None,
                           setup["transform"], batch_size=batch_size)
    return ({"count": len(names), "vecs": vecs, "names": names},)


def _infer_images(params, data_cfg, out_cfg, names, dev):
    """The image output: same-shape batches of `loader.batch_size` through
    the network in eval mode, each output written by an RgbImageSaver."""
    if data_cfg.get("shape_bucket"):
        raise ValueError("data.shape_bucket needs an embedding output (an "
                         "image would keep the pad band)")
    model = _load_network(params["network"], dev)
    net_defaults = model.data_params if isinstance(model.data_params, dict) \
        else {}
    tf_str = data_cfg.get("transforms", net_defaults.get(
        "transforms", "pil2np | totensor | normalize"))
    mean_std = data_cfg.get("mean_std", net_defaults.get("mean_std",
                                                         GAN_MEAN_STD))
    sink = RgbImageSaver(out_cfg.pop("directory"), mean_std,
                         structure=out_cfg.pop("structure", None),
                         append=bool(out_cfg.pop("append", False)),
                         stretch_by=out_cfg.pop("stretch_by", "meanstd"),
                         transforms=tf_str)
    # uint8 images go up and are normalized on the device where the
    # pipeline splits so (the generators' pil2np | totensor | normalize);
    # a sink that mixes the input in takes the host chain's normalized one
    transform, device_pre = split_device_transform(tf_str, mean_std)
    if device_pre is None or sink.needs_input:
        transform, device_pre = initialize_transforms(tf_str, mean_std), None
    # `device_postprocess: true` quantizes to uint8 on the device in
    # float32 (1/4 of the download); the host sink's float64 can differ by
    # one level at a truncation tie, so it is opt-in, and only for the
    # plain "meanstd" RGB sink (the JAX package's rule)
    device_post = bool(data_cfg.get("device_postprocess", False)
                       and sink.stretch_by == "meanstd"
                       and sink.colorspace is None and not sink.needs_input
                       and sink.normspace in (None, "rgb"))

    fwd_cfg = dict(params.get("forward") or {})
    fwd_kwargs = dict(fwd_cfg.get("params") or {})
    method = fwd_cfg.get("method")
    if method:
        bound = getattr(model.module, method)

        def run(x):
            return apply_wrapped(model.wrappers_eval,
                                 lambda xx: bound(xx, **fwd_kwargs), x, {})
    else:
        def run(x):
            return model.apply(x, train=False, **fwd_kwargs)

    names = sink.exclude_existing(names)
    batch_size = int((data_cfg.get("loader") or {}).get("batch_size", 8))
    image_dir = resolve_path(data_cfg.get("image_dir", ""))
    image_size = data_cfg.get("image_size")

    def load(i):
        img = imread(path_join(image_dir, names[i]))
        if image_size:
            img = imresize(img, int(image_size))
        return np.asarray(transform(img))

    def flush(batch_names, arrays):
        x = upload(np.stack(arrays), dev)
        with torch.no_grad():
            if device_pre is not None:
                x = device_pre(x.float() / 255.0)
            out = run(x)
            out = (device_quantize_rgb(out, mean_std) if device_post
                   else out.float()).cpu().numpy()
        for name, y, inp in zip(batch_names, out, arrays):
            sink.add(name, y, inp if sink.needs_input else None)

    try:
        buckets = {}
        for i, arr in _prefetched(len(names), load,
                                  depth=max(8, batch_size)):
            bucket = buckets.setdefault(arr.shape, ([], []))
            bucket[0].append(names[i])
            bucket[1].append(arr)
            if len(bucket[0]) == batch_size:
                flush(*buckets.pop(arr.shape))
        for shape in list(buckets):
            flush(*buckets.pop(shape))
    finally:
        sink.close()
    return ({"count": len(names)},)


def _load_network(net_cfg, device):
    """A WrappedNet on `device` from a SingleNetwork section: the built net
    with seeded weights (`path: null`), a reference `.pth` checkpoint, or
    the port's own network file (`learning/checkpoints.py`, e.g.
    `epochs/embed_best.ckpt`: {"type", "frozen", "network_params",
    "model_state"}). URLs are refused: this package downloads nothing.

    A config without a `model` section (path only) takes the checkpoint's
    `network_params.model`, and the checkpoint's data params under its own
    `runtime.data` (the config's keys win), as the reference does. The
    effective model config is kept as `net.loaded_model_cfg`."""
    net_cfg = dict(net_cfg)
    net_cfg.pop("type", None)
    path = net_cfg.pop("path", None)
    net_state = None
    if path:
        path = resolve_path(str(path))
        if "://" in path:
            raise NotImplementedError(
                "network checkpoint %r: only local files load (this package "
                "downloads nothing)" % path)
        try:
            # the port's own files hold tensors and plain containers only
            state = torch.load(path, map_location="cpu",
                               weights_only=not path.endswith((".pth",
                                                               ".pt")))
        except pickle.UnpicklingError as e:
            raise ValueError(
                "network checkpoint %r is not a torch file: a reference "
                ".pth or the port's own network file loads, the JAX "
                "package's flax checkpoints do not" % path) from e
        net_state = _checkpoint_net_state(state)
        if "model" not in net_cfg:
            ckpt_params = net_state.get("network_params") or {}
            if "model" in ckpt_params:
                net_cfg["model"] = dict(ckpt_params["model"])
            ck_data = _checkpoint_data_params(net_state, {})
            if ck_data:
                rt = dict(net_cfg.get("runtime") or {})
                rt["data"] = {**ck_data, **(rt.get("data") or {})}
                net_cfg["runtime"] = rt
    net = build_single_net(net_cfg, device="cpu")
    if net_state is None:
        _init_random(net.module, 0)
    else:
        # every parameter of the net must come from the checkpoint; keys it
        # has beyond them are ignored, as in the JAX package
        missing, _ = net.module.load_state_dict(
            _checkpoint_model_state(net_state), strict=False)
        if missing:
            raise KeyError("checkpoint %r lacks %s" % (path, missing))
    net.module.to(device).eval()
    net.loaded_model_cfg = dict(net_cfg.get("model") or {})
    return net


def infer_incrementally(params, data, device=None):
    """Infer only the identifiers missing from an existing (identifier,
    value) store and merge (the reference's infer.py:69-84): data =
    (identifier_existing, value_existing, identifier_new); returns
    (metadata, identifier_new, value_new), the values one row an
    identifier (a numpy array where value_existing is one). Runs on cuda
    unless `device="cpu"`."""
    if len(data) != 3:
        raise ValueError(
            "infer_incrementally needs (identifier_existing, value_existing, "
            "identifier_new): it is a programmatic API (no scenario step "
            "passes it stdin data, as in the reference), got %d data "
            "item(s)" % len(data))
    identifier_existing, value_existing, identifier_new = data
    existing = dict(zip(identifier_existing, list(value_existing)))
    for_inference = [x for x in identifier_new if x not in existing]

    (metadata,) = infer(dict(params), (for_inference,), device=device)
    added = {}
    if "vecs" in metadata:  # the embedding output: (D, N) columns -> rows
        added = dict(zip(for_inference,
                         list(np.asarray(metadata["vecs"]).T)))

    value_new = [existing[x] if x in existing else added[x]
                 for x in identifier_new]
    if isinstance(value_existing, np.ndarray):
        value_new = np.array(value_new)
    return (metadata, identifier_new, value_new)
