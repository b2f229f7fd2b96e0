"""Model registry (counterpart of gandtr_tpu/models/__init__.py). Ported so
far: the descriptor net `cirnet` (GeM VGG16) and the ResNet generator
`official_resnet_generator`."""
from gandtr_tpu_torch.models.generators import ResnetGenerator
from gandtr_tpu_torch.models.retrieval import GemRetrievalNet


def _cirnet(**kw):
    arch = kw.pop("cir_architecture", None) or kw.pop("architecture", "vgg16")
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


MODEL_LABELS = {
    "cirnet": _cirnet,
    "official_resnet_generator": _resnet_generator,
}


def initialize_model(params):
    """Build a model from a config dict with an `architecture` key."""
    params = dict(params)
    architecture = params.pop("architecture")
    if architecture not in MODEL_LABELS:
        raise NotImplementedError("architecture %r is not ported yet"
                                  % architecture)
    return MODEL_LABELS[architecture](**params)
