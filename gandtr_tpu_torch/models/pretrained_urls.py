"""The cirtorch pretrained-file tables and their local loaders
(counterpart of gandtr_tpu/models/pretrained_urls.py; cirtorch's
imageretrievalnet.py:19-67, 237-275).

- FEATURES: the caffe-converted ImageNet backbones (:19-24), where every
  reference fine-tune starts;
- L_WHITENING, R_WHITENING, WHITENING: precomputed whitening files for
  architecture-pooling pairs (:28-67).

The tables keep the published URLs, but this package downloads nothing:
each loader takes a local path (the file put in place by hand); a table
key or a URL without one raises (utils/io.py::fetch).
"""
import numpy as np
import torch

_CIR = "http://cmp.felk.cvut.cz/cnnimageretrieval/data"

FEATURES = {
    "vgg16": f"{_CIR}/networks/imagenet/imagenet-caffe-vgg16-features-d369c8e.pth",
    "resnet50": f"{_CIR}/networks/imagenet/imagenet-caffe-resnet50-features-ac468af.pth",
    "resnet101": f"{_CIR}/networks/imagenet/imagenet-caffe-resnet101-features-10a101d.pth",
    "resnet152": f"{_CIR}/networks/imagenet/imagenet-caffe-resnet152-features-1011020.pth",
}

_W = f"{_CIR}/whiten/retrieval-SfM-120k/retrieval-SfM-120k"

L_WHITENING = {
    "resnet101": f"{_W}-resnet101-lwhiten-9f830ef.pth",
}

R_WHITENING = {
    "alexnet-gem-r": f"{_W}-alexnet-gem-r-rwhiten-c8cf7e2.pth",
    "vgg16-gem-r": f"{_W}-vgg16-gem-r-rwhiten-19b204e.pth",
    "resnet101-mac-r": f"{_W}-resnet101-mac-r-rwhiten-7f1ed8c.pth",
    "resnet101-gem-r": f"{_W}-resnet101-gem-r-rwhiten-adace84.pth",
}

WHITENING = {
    "alexnet-gem": f"{_W}-alexnet-gem-whiten-454ad53.pth",
    "alexnet-gem-r": f"{_W}-alexnet-gem-r-whiten-4c9126b.pth",
    "vgg16-gem": f"{_W}-vgg16-gem-whiten-eaa6695.pth",
    "vgg16-gem-r": f"{_W}-vgg16-gem-r-whiten-83582df.pth",
    "resnet50-gem": f"{_W}-resnet50-gem-whiten-f15da7b.pth",
    "resnet101-mac-r": f"{_W}-resnet101-mac-r-whiten-9df41d3.pth",
    "resnet101-gem": f"{_W}-resnet101-gem-whiten-22ab0c1.pth",
    "resnet101-gem-r": f"{_W}-resnet101-gem-r-whiten-b379c0a.pth",
    "resnet101-gemmp": f"{_W}-resnet101-gemmp-whiten-770f53c.pth",
    "resnet152-gem": f"{_W}-resnet152-gem-whiten-abe7b93.pth",
    "densenet121-gem": f"{_W}-densenet121-gem-whiten-79e3eea.pth",
    "densenet169-gem": f"{_W}-densenet169-gem-whiten-6b2a76a.pth",
    "densenet201-gem": f"{_W}-densenet201-gem-whiten-22ea45c.pth",
}


def load_backbone_features(module, architecture, path=None):
    """Fill a GeM net's backbone (`features.*`) from a FEATURES checkpoint,
    a bare `features` state dict with '0.weight'-style keys
    (imageretrievalnet.py:237-246), in place. Every backbone parameter
    must be covered; the pooling and whitening keep their values. Returns
    the module."""
    from gandtr_tpu_torch.utils.io import fetch
    state = torch.load(fetch(path or FEATURES[architecture]),
                       map_location="cpu", weights_only=False)
    state = {(k if k.startswith("features.") else "features." + k):
             torch.as_tensor(v) for k, v in state.items()}
    own = {k for k in module.state_dict() if k.startswith("features.")}
    missing = sorted(own - set(state))
    if missing:
        raise KeyError("the features checkpoint lacks %d backbone keys "
                       "(%s ...)" % (len(missing), missing[:3]))
    module.load_state_dict(state, strict=False)
    return module


def load_whitening(key_or_path, table=WHITENING):
    """A precomputed whitening file (a key of `table` names its published
    file, which must then be local) -> {'m': (D, 1), 'P': (D, D)} float64
    (imageretrievalnet.py:257-261)."""
    from gandtr_tpu_torch.utils.io import load_torch_checkpoint
    w = load_torch_checkpoint(table.get(key_or_path, key_or_path))
    return {"m": np.asarray(w["m"], np.float64).reshape(-1, 1),
            "P": np.asarray(w["P"], np.float64)}


def init_network(params=None, **kw):
    """cirtorch's `init_network`: a GeM net from an option dict
    (architecture, pooling, local_whitening, whitening, regional,
    pretrained; imageretrievalnet.py:90-141) -> the module, on the CPU.
    With `pretrained` the backbone loads from `features_path`, a local
    copy of the FEATURES file. Precomputed whitening is not folded into the
    net: `load_whitening` it and apply it with ops/whiten.py."""
    from gandtr_tpu_torch.models import initialize_model
    params = dict(params or {}, **kw)
    pretrained = params.pop("pretrained", False)
    features_path = params.pop("features_path", None)
    params.setdefault("architecture", "cirnet")
    arch = params.get("cir_architecture", "vgg16")
    module = initialize_model(params)
    if pretrained:
        load_backbone_features(module, arch, features_path)
    return module
