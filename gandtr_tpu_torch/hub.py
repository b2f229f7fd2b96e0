"""Public model API (counterpart of gandtr_tpu/hub.py): the GeM descriptor
nets `gem_vgg16_cyclegan`, `gem_vgg16_hedngan` (512-d),
`gem_resnet101_cyclegan` and `gem_resnet101_hedngan` (2048-d), and the
day-to-night ResNet generators `cyclegan` and `hedngan`.

`pretrained=False` gives seeded random weights (made on the CPU from a
`torch.Generator`, then moved, so every device holds the same net). With
`pretrained=True` the caller passes a local checkpoint path, and optionally
a local learned-whitening (Lw) pickle: this package downloads nothing. The
published files are at `BASE_URL`. A descriptor checkpoint's own data
params (`network_params.runtime.data`) set the model's transform and
`net.data_params`, as in the reference hub.

Each entry point runs on `cuda` unless the caller passes `device="cpu"`
(device.py). `model(images)` takes normalized (N, H, W, 3) float images
and returns (N, D) descriptors or, for a generator, (N, H, W, 3) images in
(-1, 1); `model.transform(pil_or_uint8)` is the host preprocessing of one
image. Mixed precision is `model.net.compute_dtype = torch.bfloat16`, as the
JAX package's `WrappedNet.compute_dtype`.
"""
import math
import pickle

import torch

from gandtr_tpu_torch.data.transforms import initialize_transforms
from gandtr_tpu_torch.device import resolve_device
from gandtr_tpu_torch.learning.network import WrappedNet
from gandtr_tpu_torch.learning.wrappers import (CirMultiscaleAggregation,
                                                CirtorchWhiten)
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.init import initialize_weights

BASE_URL = "http://ptak.felk.cvut.cz/personal/jenicto2/download/iccv23_gan/"

EMBEDDING_DATA = {
    "transforms": "pil2np | apply_clahe:1.0 | totensor | normalize",
    "mean_std": [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]],
}
GENERATOR_DATA = {
    "transforms": "pil2np | totensor | normalize",
    "mean_std": [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]],
}


class HubModel:
    """A net on a device with its host preprocessing transform.
    `model(model.transform(img)[None])` -> (N, D) descriptors, or (N, H, W,
    3) images for a generator: in the net's compute dtype, or float32 where
    a frozen BatchNorm promoted them, as in the JAX package."""

    def __init__(self, net, transform, device, meta=None):
        self.net = net
        self.transform = transform
        self.device = device
        self.meta = meta or {}

    @torch.inference_mode()
    def __call__(self, images):
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.dim() == 3:
            x = x[None]
        return self.net.apply(x, ctx={"msp": self.meta.get("msp", 1.0)})


def _init_random(module, seed=0):
    """Seeded He-normal convolution (transposed too)/linear weights, zero
    biases (BatchNorm keeps its identity init): the same numbers on every
    device and every call, since they are drawn on the CPU from the seed
    alone."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape).normal_(
                    0.0, math.sqrt(2.0 / fan_in), generator=g)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def _checkpoint_net_state(state):
    """The network entry of a loaded checkpoint: the reference's flat file
    {"network_params", "model_state", ...}, a wrapped {"net": {...}}, or a
    plain state dict (taken as {"model_state": state})."""
    if not isinstance(state, dict):
        raise TypeError("checkpoint is not a dict: %r" % type(state))
    if "net" in state:
        state = state["net"]
    return state if "model_state" in state else {"model_state": state}


def _checkpoint_model_state(state):
    """The parameter state dict of a loaded network checkpoint (any layout
    `_checkpoint_net_state` takes)."""
    return {k: torch.as_tensor(v)
            for k, v in _checkpoint_net_state(state)["model_state"].items()}


def _checkpoint_data_params(net_state, default):
    """The checkpoint's runtime data params (`network_params.runtime.data`)
    over `default`: its transform pipeline, under `transforms` or the
    reference's older name `augmentations` (the first wins), and its
    `mean_std`; each absent key keeps the default."""
    runtime = (net_state.get("network_params") or {}).get("runtime") or {}
    data = runtime.get("data") or {}
    out = dict(default)
    tf = data.get("transforms", data.get("augmentations"))
    if tf:
        out["transforms"] = tf
    if data.get("mean_std"):
        out["mean_std"] = data["mean_std"]
    return out


def _local(path, what):
    if path is None or "://" in str(path):
        raise ValueError(
            "%s must be a local file (this package downloads nothing; the "
            "published files are under %s), got %r" % (what, BASE_URL, path))
    return path


def _embedding(architecture, checkpoint=None, whitening=None,
               pretrained=True, multiscale=True, device=None, seed=0):
    """A GeM descriptor net with the eval chain of the reference hub:
    (Lw whitening) after multiscale aggregation. `whitening` is a local Lw
    pickle path or a {"P", "m"} dict."""
    dev = resolve_device(device)
    module = initialize_model({
        "architecture": "cirnet", "cir_architecture": architecture,
        "pooling": "gem", "local_whitening": False, "whitening": False})
    _init_random(module, seed)
    data_params = dict(EMBEDDING_DATA)
    if pretrained:
        state = torch.load(_local(checkpoint, "checkpoint"),
                           map_location="cpu", weights_only=False)
        net_state = _checkpoint_net_state(state)
        module.load_state_dict(_checkpoint_model_state(net_state),
                               strict=True)
        data_params = _checkpoint_data_params(net_state, data_params)
    module.to(dev).eval()

    eval_wrappers = []
    if whitening is not None:
        lw = whitening
        if not isinstance(lw, dict):
            with open(_local(lw, "whitening"), "rb") as f:
                lw = pickle.load(f)
        eval_wrappers.append(CirtorchWhiten(P=lw["P"], m=lw["m"], device=dev))
    msp = 1.0
    if multiscale:
        eval_wrappers.append(CirMultiscaleAggregation(scales=True))
        msp = float(module.pool.p.detach().cpu()[0])
    net = WrappedNet(module=module, wrappers_eval=eval_wrappers,
                     meta=module.meta, data_params=data_params)
    transform = initialize_transforms(data_params["transforms"],
                                      data_params["mean_std"])
    return HubModel(net, transform, dev, meta={**module.meta, "msp": msp})


def gem_vgg16_cyclegan(pretrained=False, device=None, checkpoint=None,
                       whitening=None):
    """GeM VGG16 descriptor net fine-tuned with CycleGAN augmentation +
    CLAHE (published as cyclegan_embed_vgg16.pth and its _lw.pkl)."""
    return _embedding("vgg16", checkpoint, whitening, pretrained,
                      device=device)


def gem_vgg16_hedngan(pretrained=False, device=None, checkpoint=None,
                      whitening=None):
    """GeM VGG16 descriptor net fine-tuned with HED^N-GAN augmentation +
    CLAHE (published as hedngan_embed_vgg16.pth and its _lw.pkl)."""
    return _embedding("vgg16", checkpoint, whitening, pretrained,
                      device=device)


def gem_resnet101_cyclegan(pretrained=False, device=None, checkpoint=None,
                           whitening=None):
    """GeM ResNet-101 descriptor net fine-tuned with CycleGAN augmentation
    (published as cyclegan_embed_resnet101.pth and its _lw.pkl)."""
    return _embedding("resnet101", checkpoint, whitening, pretrained,
                      device=device)


def gem_resnet101_hedngan(pretrained=False, device=None, checkpoint=None,
                          whitening=None):
    """GeM ResNet-101 descriptor net fine-tuned with HED^N-GAN augmentation
    (published as hedngan_embed_resnet101.pth and its _lw.pkl)."""
    return _embedding("resnet101", checkpoint, whitening, pretrained,
                      device=device)


def _generator(norm_layer="instance", checkpoint=None, pretrained=True,
               init_weights="normal_p2p", seed=0, device=None):
    """The 9-block ResNet generator of the reference hub (no_antialias,
    reflect padding), with seeded `init_weights` or a local checkpoint. A
    checkpoint whose `network_params.model` is a ResNet generator's config
    (the reference's files, and the port's own epoch files, e.g. HED^N-GAN
    training's batch-norm generator_X) builds that config."""
    dev = resolve_device(device)
    config = {"architecture": "official_resnet_generator",
              "no_antialias": True, "no_antialias_up": True,
              "input_nc": 3, "output_nc": 3, "n_blocks": 9,
              "norm_layer": norm_layer}
    state = None
    if pretrained:
        state = torch.load(_local(checkpoint, "checkpoint"),
                           map_location="cpu", weights_only=False)
        model = dict((_checkpoint_net_state(state).get("network_params")
                      or {}).get("model") or {})
        if model.get("architecture") == config["architecture"]:
            model.pop("pretrained", None)
            config = model
    module = initialize_model(config)
    if pretrained:
        module.load_state_dict(_checkpoint_model_state(state), strict=True)
    else:
        initialize_weights(module, init_weights, seed=seed)
    module.to(dev).eval()
    net = WrappedNet(module=module, meta=module.meta,
                     data_params=dict(GENERATOR_DATA))
    transform = initialize_transforms(GENERATOR_DATA["transforms"],
                                      GENERATOR_DATA["mean_std"])
    return HubModel(net, transform, dev, meta=dict(module.meta))


def cyclegan(pretrained=False, device=None, checkpoint=None):
    """ResNet CycleGAN day-to-night generator: instance norm, normal_p2p
    init (published as cyclegan_generator_X.pth)."""
    return _generator("instance", checkpoint, pretrained, device=device)


def hedngan(pretrained=False, device=None, checkpoint=None):
    """ResNet HED^N-GAN day-to-night generator (published as
    hedngan_generator_X.pth, instance norm; a checkpoint of the port's
    HED^N-GAN training, e.g. epochs/generator_X_last.ckpt, is batch norm,
    which its network_params say); not pretrained it is the reference's
    batch-norm default with kaiming_p2p init."""
    return _generator("instance" if pretrained else "batch", checkpoint,
                      pretrained, init_weights="kaiming_p2p", device=device)
