"""Model registry (counterpart of gandtr_tpu/models/__init__.py): every
label of the JAX package's MODEL_LABELS, with the same config keys and
defaults: the descriptor nets (`cirnet` with its dict-form pooling and
`regional`, `cirnet_inchan`, `cirnet_attention`, `gem_retrieval`), the
generators (`official_resnet_generator`, `official_resnet_encoder` /
`_decoder`, `official_unet_generator`, `official_p2p_unet_generator` and
the seven U-Nets of models/unet.py), the PatchGAN discriminators, the edge
detectors `hed_interpolation` and `rcf`, CUT's feature sampler
`official_p2p_mlp`, `identity` and `normalization_l2`."""
from torch import nn

from gandtr_tpu_torch.models import unet as unet_mod
from gandtr_tpu_torch.models.discriminators import (NLayerDiscriminator,
                                                    PatchDiscriminator)
from gandtr_tpu_torch.models.generators import (ResnetDecoder, ResnetEncoder,
                                                ResnetGenerator,
                                                UnetGenerator)
from gandtr_tpu_torch.models.hed import HedInterpolation
from gandtr_tpu_torch.models.patchsample import PatchSampleF
from gandtr_tpu_torch.models.rcf import RCF
from gandtr_tpu_torch.models.retrieval import (GemRetrievalNet,
                                               GemRetrievalNetAttention,
                                               GemRetrievalNetPreprocessing)
from gandtr_tpu_torch.ops.norm import l2n


class Identity(nn.Module):
    meta = {"in_channels": 3, "out_channels": 3}

    def forward(self, x):
        return x


class NormalizationL2(nn.Module):
    """L2N as a net (single_layer.py:7-13)."""
    meta = {"in_channels": 3, "out_channels": 3}

    def forward(self, x):
        return l2n(x)


def _cirnet(**kw):
    arch = kw.pop("cir_architecture", None) or kw.pop("architecture", "vgg16")
    pooling = kw.pop("pooling", "gem")
    pooling_params = None
    if isinstance(pooling, dict):
        # {type: GeometricMedianWeiszfeld, iterations: 3, ...}
        # (cirnet.py:61-63)
        pooling_params = dict(pooling)
        pooling = pooling_params.pop("type")
    return GemRetrievalNet(
        architecture=arch,
        pooling=pooling,
        pooling_params=pooling_params,
        local_whitening=bool(kw.pop("local_whitening", False)),
        whitening=bool(kw.pop("whitening", False)),
        regional=bool(kw.pop("regional", False)),
    )


def _cirnet_inchan(inputs=None, **kw):
    """cirnet with `inputs.preprocessing` (cirnet.py:85-105): the edge
    filter before the whole configured net; without it, plain cirnet."""
    pre = (inputs or {}).get("preprocessing")
    if pre:
        pre = dict(pre)
        return GemRetrievalNetPreprocessing(
            architecture=kw.pop("cir_architecture", "vgg16"),
            pooling=kw.pop("pooling", "gem"),
            preprocessing=pre.pop("type", "edgefilter"),
            preprocessing_params=pre,
            local_whitening=bool(kw.pop("local_whitening", False)),
            whitening=bool(kw.pop("whitening", False)),
            regional=bool(kw.pop("regional", False)))
    return _cirnet(**kw)


def _cirnet_attention(attention=None, **kw):
    att = dict(attention or {"type": "l2norm"})
    return GemRetrievalNetAttention(
        architecture=kw.pop("cir_architecture", "vgg16"),
        pooling=kw.pop("pooling", "gem"),
        attention=att.pop("type", "l2norm"),
        normalize_max=bool(att.pop("normalize_max", True)))


def _resnet_generator(**kw):
    # the reference's default is BATCH norm (p2p_networks.py:245); every
    # iccv23 config sets norm_layer: instance explicitly
    kw.setdefault("norm_type", kw.pop("norm_layer", "batch"))
    kw.pop("track_running_stats", None)
    return ResnetGenerator(**kw)


def _unet_generator(**kw):
    kw.setdefault("norm_type", kw.pop("norm_layer", "batch"))
    return UnetGenerator(**kw)


def _discriminator(**kw):
    kw.setdefault("norm_type", kw.pop("norm_layer", "batch"))
    kw.pop("track_running_stats", None)
    return NLayerDiscriminator(**kw)


def _mlp(**kw):
    # the reference's eager-MLP arguments: the MLPs are made from the
    # generator's taps (scenarios/build.py), their weights by `initialize`
    for k in ("init_type", "init_gain", "input_nc", "nce_layers"):
        kw.pop(k, None)
    return PatchSampleF(**kw)


def _patch_discriminator(**kw):
    kw.setdefault("norm_type", kw.pop("norm_layer", "batch"))
    return PatchDiscriminator(**kw)


MODEL_LABELS = {
    "identity": lambda **kw: Identity(),
    "orig_unet": lambda **kw: unet_mod.OrigUNet(**kw),
    "p2p_unet": lambda **kw: unet_mod.P2pUNet(**kw),
    "outconv_unet": lambda **kw: unet_mod.OutconvP2pUNet(**kw),
    "outconv_dynint_unet":
        lambda **kw: unet_mod.OutconvP2pUNetDynamicInterpolate(**kw),
    "shallow_p2p_unet": lambda **kw: unet_mod.ShallowP2pUNet(**kw),
    "inconv_p2p_unet": lambda **kw: unet_mod.InconvP2pUNet(**kw),
    "aligned_p2p_unet": lambda **kw: unet_mod.AlignedP2pUNet(**kw),
    "official_p2p_unet_generator": _unet_generator,
    "cirnet_inchan": _cirnet_inchan,
    "cirnet_attention": _cirnet_attention,
    "normalization_l2": lambda **kw: NormalizationL2(),
    "rcf": lambda **kw: RCF(),
    "official_resnet_generator": _resnet_generator,
    "official_resnet_encoder": lambda **kw: ResnetEncoder(**kw),
    "official_resnet_decoder": lambda **kw: ResnetDecoder(**kw),
    "official_unet_generator": _unet_generator,
    "official_p2p_discriminator": _discriminator,
    "official_patch_discriminator": _patch_discriminator,
    "official_p2p_mlp": _mlp,
    "hed_interpolation": lambda **kw: HedInterpolation(
        width_mult=float(kw.get("width_mult", 1.0))),
    "cirnet": _cirnet,
    "gem_retrieval": lambda **kw: GemRetrievalNet(**kw),
}


def initialize_model(params):
    """Build a model from a config dict with an `architecture` key."""
    params = dict(params)
    architecture = params.pop("architecture")
    return MODEL_LABELS[architecture](**params)
