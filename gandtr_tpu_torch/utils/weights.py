"""Weights carried across from the JAX package's models.

`from_jax_variables` turns a JAX `variables` tree (nested dicts of numpy
arrays: `params`, and `batch_stats` where there is a BatchNorm) into a
PyTorch `state_dict` with the reference's torch names: the inverse of the
JAX package's torch importer (gandtr_tpu/utils/torch_import.py).

GeM nets (models/retrieval.py):

    backbone/features_<i>/conv/kernel (3, 3, I, O) -> features.<i>.weight (O, I, 3, 3)
    backbone/features_<i>/conv/bias                 -> features.<i>.bias
    gem_p (1,), or (dim,) for gemmp                 -> pool.p
    whiten|lwhiten/kernel (in, out)                 -> whiten|lwhiten.weight (out, in)
    whiten|lwhiten/bias                             -> whiten|lwhiten.bias

with `regional` (cirtorch's Rpool) and the preprocessing net
(cirnet_inchan, whose JAX net nests under `net/`):

    gem_p (1,), regional                            -> pool.rpool.p
    rwhiten/kernel (in, out), rwhiten/bias          -> pool.whiten.weight (out, in), pool.whiten.bias
    net/<path>                                      -> as <path> above
    preprocessing/p, preprocessing/tau              -> preprocessing.p, preprocessing.tau

and the ResNet backbones, torchvision's layout (`features.0` conv1,
`features.1` bn1, `features.<3+l>` layer<l>), with BatchNorm as below:

    backbone/conv1/conv/kernel                      -> features.0.weight
    backbone/bn1/scale, bias; batch_stats mean, var -> features.1.weight, bias, running_mean, running_var
    backbone/layer<l>_<b>/conv<i>/conv/kernel       -> features.<3+l>.<b>.conv<i>.weight
    backbone/layer<l>_<b>/bn<i>/...                 -> features.<3+l>.<b>.bn<i>....
    backbone/layer<l>_<b>/downsample_<j>/...        -> features.<3+l>.<b>.downsample.<j>....

Generators (models/generators.py), `<name>_<i>` -> `<name>.<i>`, the `conv`
wrapper level dropped:

    model_10/conv_block_1/conv/kernel (kh, kw, I, O) -> model.10.conv_block.1.weight (O, I, kh, kw)
    model_19/kernel (kh, kw, I, O), a ConvTranspose  -> model.19.weight (I, O, kh, kw)
    model_2/scale, model_2/bias (BatchNorm)          -> model.2.weight, model.2.bias
    batch_stats: model_2/mean, model_2/var           -> model.2.running_mean, model.2.running_var

and each BatchNorm gets `num_batches_tracked` = 0, which torch's state has
and JAX's has not, so the result loads with `strict=True`.

The ResNet encoder and decoder, the blur-pool generator and the U-Nets of
models/unet.py take the same rule (`skip_0/down/conv/kernel` ->
`skip.0.down.weight`); the blur filters are constants that JAX keeps no
variable of, and the port's blur layers keep theirs when a state lacks
them. pix2pix's U-Net generator (`inner`, `mid_<i>`, `up4`, `up2`, `up1`,
`outer`, each with `downconv`, `downnorm`, `upconv`, `upnorm`) takes its
nested torch names: block d from the outside is under `model.model.` +
`1.model.` (d >= 1) + `3.model.` x (d - 1), its layers at their
Sequential indices (outermost: downconv 0, upconv 3; innermost: downconv
1, upconv 3, upnorm 4; the others: downconv 1, downnorm 2, upconv 5,
upnorm 6).

Discriminators follow the same rule (`model_<i>` -> `model.<i>`, and
`d/model_<i>` -> `d.model.<i>` in the patch discriminator). HED
(models/hed.py) takes the JAX package's `hed_key_map`, kept here as its
own copy:

    vgg<b>_<c>/conv/kernel -> vgg<b>.<2c, or 2c + 1 after block 1's>.weight
    score<b>/conv/kernel   -> score<b>.weight
    fusion/conv/kernel     -> fusion.0.weight

which are the names of the published `hed_sniklaus_github.pth` too.
RCF (models/rcf.py) takes the JAX package's `rcf_key_map`, and CUT's
PatchSampleF (models/patchsample.py) its `patchsample_key_map`:

    conv<s>_<c>[_down]|score_dsn<s>|score_fuse/conv/kernel -> <same>.weight
    mlp_<i>_0/kernel (in, out), mlp_<i>_1/kernel     -> mlp_<i>.0.weight (out, in), mlp_<i>.2.weight

the names of the published `rcf_bsds500_pascal_model.pth` and of the
reference's PatchSampleF.

The fine-tune tree {"augment": variables, "embed": variables} (the JAX
fine-tune state's `variables`) gives {"augment": state_dict, "embed":
state_dict}, the generator's batch statistics and the GeM `p` included;
a GAN state's {"generator_X": ..., "detector": ..., ...} likewise.

`load_pretrained` fills a module from a model config's `pretrained:`
entry: a local checkpoint loads strictly (every parameter covered), null
or false keeps the module's seeded weights, and a URL raises.
"""
import re

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _retrieval_key(path, regional=False):
    if path[0] == "net":          # the preprocessing net's inner net
        path = path[1:]
    if path == ("gem_p",):
        return "pool.rpool.p" if regional else "pool.p"
    if path[0] == "preprocessing":
        return "preprocessing.%s" % path[-1]
    if path[0] == "rwhiten":
        return "pool.whiten.%s" % _LEAF[path[-1]]
    head = path[1] if path[0] == "backbone" else path[0]
    if head.startswith("features_"):
        return "features.%s.%s" % (head.split("_")[1], _LEAF[path[-1]])
    if path[0] == "backbone":
        return _resnet_key(path[1:])
    if head in ("whiten", "lwhiten"):
        return "%s.%s" % (head, _LEAF[path[-1]])
    return None


def _resnet_key(path):
    leaf = _LEAF[path[-1]]
    head = path[0]
    if head == "conv1":
        return "features.0.%s" % leaf
    if head == "bn1":
        return "features.1.%s" % leaf
    if head.startswith("layer"):
        layer, block = head[len("layer"):].split("_")
        inner = path[1]
        if inner.startswith("downsample_"):
            inner = "downsample." + inner.split("_")[1]
        return "features.%d.%s.%s.%s" % (3 + int(layer), block, inner, leaf)
    return None


def hed_key_map(path):
    """The JAX package's hed_key_map: vgg<b>_<c> -> vgg<b>.<index in the
    torch Sequential> (block 1 is [conv relu conv relu], the others start
    with a max-pool); score<b> is a conv; fusion a Sequential."""
    p = path[0]
    leaf = {"kernel": "weight", "bias": "bias"}.get(path[-1], path[-1])
    if p.startswith("vgg"):
        block, ci = p[3:].split("_")
        return "vgg%s.%d.%s" % (block, int(ci) * 2 + (block != "1"), leaf)
    if p.startswith("score"):
        return "%s.%s" % (p, leaf)
    if p == "fusion":
        return "fusion.0.%s" % leaf
    return None


def rcf_key_map(path):
    """The JAX package's rcf_key_map: every RCF conv is `<name>.<leaf>`."""
    return "%s.%s" % (path[0], {"kernel": "weight", "bias": "bias"}[path[-1]])


def patchsample_key_map(path):
    """The JAX package's patchsample_key_map: mlp_<i>_<j> -> mlp_<i>.<0|2>
    (torch Sequential(Linear, ReLU, Linear))."""
    _, i, j = path[0].split("_")
    return "mlp_%s.%d.%s" % (i, 0 if j == "0" else 2,
                             {"kernel": "weight", "bias": "bias"}[path[-1]])


_UNET_LAYERS = {"outer": {"downconv": 0, "upconv": 3},
                "inner": {"downconv": 1, "upconv": 3, "upnorm": 4},
                None: {"downconv": 1, "downnorm": 2, "upconv": 5,
                       "upnorm": 6}}


def _unet_generator_key_map(params):
    """pix2pix's nested names for a JAX UnetGenerator tree."""
    n_mid = sum(1 for k in params if k.startswith("mid_"))
    chain = (["outer", "up1", "up2", "up4"]
             + ["mid_%d" % i for i in reversed(range(n_mid))] + ["inner"])
    depth = {name: d for d, name in enumerate(chain)}

    def key(path):
        block, layer = path[0], path[1]
        d = depth[block]
        prefix = "model.model." + ("1.model." if d else "") \
            + "3.model." * max(d - 1, 0)
        j = _UNET_LAYERS.get(block if block in ("outer", "inner")
                             else None)[layer]
        return "%s%d.%s" % (prefix, j, _LEAF[path[-1]])
    return key


def _key_map(params):
    """The naming rule of a JAX params tree: HED's, RCF's, PatchSampleF's,
    the U-Net generator's, the retrieval nets' or the generic one."""
    if "outer" in params and "inner" in params:
        return _unet_generator_key_map(params)
    if "rwhiten" in params or "rwhiten" in params.get("net", {}):
        return lambda path: _retrieval_key(path, regional=True)
    if "fusion" in params and any(re.match(r"vgg\d_\d+$", k)
                                  for k in params):
        return hed_key_map
    if "score_fuse" in params:
        return rcf_key_map
    if params and all(re.match(r"mlp_\d+_[01]$", k) for k in params):
        return patchsample_key_map
    return _torch_key


def _torch_key(path):
    key = _retrieval_key(path)
    if key is not None:
        return key
    parts = []
    for p in path[:-1]:
        head, _, tail = p.rpartition("_")
        if p == "conv":  # the JAX Conv wrapper's level, absent in torch
            continue
        parts += [head, tail] if head and tail.isdigit() else [p]
    if not parts or path[-1] not in _LEAF:
        raise KeyError("no torch name for JAX parameter %s" % "/".join(path))
    return ".".join(parts + [_LEAF[path[-1]]])


def _layout(path, value):
    v = np.asarray(value, np.float32)
    if v.ndim == 4:
        if len(path) > 1 and path[-2] == "conv":
            return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        return v.transpose(2, 3, 0, 1)  # ConvTranspose (kh, kw, I, O) -> IOHW
    if v.ndim == 2:
        return v.T  # Dense (in, out) -> Linear (out, in)
    return v


def from_jax_variables(variables):
    """{'params': {...}[, 'batch_stats': {...}]} of numpy arrays ->
    {torch name: tensor}; a tree of such trees by net name (the fine-tune's
    {'augment', 'embed'}) -> {net name: state_dict}."""
    if "params" not in variables:
        return {name: from_jax_variables(v) for name, v in variables.items()}
    out = {}
    name = _key_map(variables["params"])
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            key = name(path)
            out[key] = torch.from_numpy(np.array(_layout(path, value)))
            if key.endswith(".running_mean"):
                out[key[:-len("running_mean")] + "num_batches_tracked"] = (
                    torch.tensor(0, dtype=torch.int64))
    return out


def load_pretrained(module, pretrained, what="pretrained"):
    """Load a model config's `pretrained:` entry into `module`: a local
    checkpoint (a reference `.pth`, flat or {"net": ...}, or a plain state
    dict) strictly, so every parameter is covered; null, false or true
    (the JAX package's "no file") keep the weights. A URL raises: this
    package downloads nothing."""
    if not pretrained or pretrained is True:
        return module
    path = str(pretrained)
    if "://" in path:
        raise NotImplementedError(
            "%s %r: only local files load (this package downloads nothing; "
            "put the file in place and give its path)" % (what, path))
    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "net" in state:
        state = state["net"]
    if isinstance(state, dict) and "model_state" in state:
        state = state["model_state"]
    module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()},
                           strict=True)
    return module
