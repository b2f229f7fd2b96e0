"""Public model API (counterpart of gandtr_tpu/hub.py) for the GeM VGG16
descriptor nets: `gem_vgg16_cyclegan` and `gem_vgg16_hedngan`.

`pretrained=False` gives seeded random weights (made on the CPU from a
`torch.Generator`, then moved, so every device holds the same net). With
`pretrained=True` the caller passes a local checkpoint path, and optionally
a local learned-whitening (Lw) pickle: this package downloads nothing. The
published files are at `BASE_URL`.

Each entry point runs on `cuda` unless the caller passes `device="cpu"`
(device.py). `model(images)` takes normalized (N, H, W, 3) float images;
`model.transform(pil_or_uint8)` is the host preprocessing of one image.
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

BASE_URL = "http://ptak.felk.cvut.cz/personal/jenicto2/download/iccv23_gan/"

EMBEDDING_DATA = {
    "transforms": "pil2np | apply_clahe:1.0 | totensor | normalize",
    "mean_std": [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]],
}


class HubModel:
    """A descriptor net on a device with its host preprocessing transform.
    `model(model.transform(img)[None])` -> (N, D) descriptors."""

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
    """Seeded He-normal convolution/linear weights, zero biases: the same
    numbers on every device, since they are drawn on the CPU."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape).normal_(
                    0.0, math.sqrt(2.0 / fan_in), generator=g)
                m.weight.copy_(w)
                m.bias.zero_()
    return module


def _checkpoint_model_state(state):
    """The parameter state dict of a loaded network checkpoint: the
    reference's flat file {"model_state", ...}, a wrapped {"net": {...}}, or
    a plain state dict."""
    if not isinstance(state, dict):
        raise TypeError("checkpoint is not a dict: %r" % type(state))
    if "net" in state:
        state = state["net"]
    state = state.get("model_state", state)
    return {k: torch.as_tensor(v) for k, v in state.items()}


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
    if pretrained:
        state = torch.load(_local(checkpoint, "checkpoint"),
                           map_location="cpu", weights_only=False)
        module.load_state_dict(_checkpoint_model_state(state), strict=True)
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
    data_params = dict(EMBEDDING_DATA)
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
