"""Model registry (counterpart of gandtr_tpu/models/__init__.py). Ported so
far: the descriptor net `cirnet` (GeM VGG16 and ResNet), the ResNet
generator `official_resnet_generator`, the PatchGAN discriminators
`official_p2p_discriminator` and `official_patch_discriminator`, the edge
detectors `hed_interpolation` and `rcf`, and CUT's feature sampler
`official_p2p_mlp`."""
from gandtr_tpu_torch.models.discriminators import (NLayerDiscriminator,
                                                    PatchDiscriminator)
from gandtr_tpu_torch.models.generators import ResnetGenerator
from gandtr_tpu_torch.models.hed import HedInterpolation
from gandtr_tpu_torch.models.patchsample import PatchSampleF
from gandtr_tpu_torch.models.rcf import RCF
from gandtr_tpu_torch.models.retrieval import GemRetrievalNet


def _cirnet(**kw):
    arch = kw.pop("cir_architecture", None) or kw.pop("architecture", "vgg16")
    if kw.pop("regional", False):
        raise NotImplementedError("regional (Rpool) is not ported yet")
    return GemRetrievalNet(
        architecture=arch,
        pooling=kw.pop("pooling", "gem"),
        local_whitening=bool(kw.pop("local_whitening", False)),
        whitening=bool(kw.pop("whitening", False)),
    )


def _resnet_generator(**kw):
    # the reference's default is BATCH norm (p2p_networks.py:245); every
    # iccv23 config sets norm_layer: instance explicitly
    kw.setdefault("norm_type", kw.pop("norm_layer", "batch"))
    kw.pop("track_running_stats", None)
    return ResnetGenerator(**kw)


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
    "cirnet": _cirnet,
    "official_resnet_generator": _resnet_generator,
    "official_p2p_discriminator": _discriminator,
    "official_patch_discriminator": _patch_discriminator,
    "hed_interpolation": lambda **kw: HedInterpolation(
        width_mult=float(kw.get("width_mult", 1.0))),
    "rcf": lambda **kw: RCF(),
    "official_p2p_mlp": _mlp,
}


def initialize_model(params):
    """Build a model from a config dict with an `architecture` key."""
    params = dict(params)
    architecture = params.pop("architecture")
    if architecture not in MODEL_LABELS:
        raise NotImplementedError("architecture %r is not ported yet"
                                  % architecture)
    return MODEL_LABELS[architecture](**params)
