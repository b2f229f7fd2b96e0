"""Model registry (counterpart of gandtr_tpu/models/__init__.py). Only the
descriptor net `cirnet` (GeM VGG16) is ported so far."""
from gandtr_tpu_torch.models.retrieval import GemRetrievalNet


def _cirnet(**kw):
    arch = kw.pop("cir_architecture", None) or kw.pop("architecture", "vgg16")
    return GemRetrievalNet(
        architecture=arch,
        pooling=kw.pop("pooling", "gem"),
        local_whitening=bool(kw.pop("local_whitening", False)),
        whitening=bool(kw.pop("whitening", False)),
    )


MODEL_LABELS = {
    "cirnet": _cirnet,
}


def initialize_model(params):
    """Build a model from a config dict with an `architecture` key."""
    params = dict(params)
    architecture = params.pop("architecture")
    if architecture not in MODEL_LABELS:
        raise NotImplementedError("architecture %r is not ported yet"
                                  % architecture)
    return MODEL_LABELS[architecture](**params)
