"""Shared set-up of the tests that hold the port's serving and retrieval
path (gandtr_tpu_torch/serving, the build_index and export stages) against
the JAX package's: small models in both packages on the same seeded
weights, the JAX variables filled over their shapes (`jax.eval_shape`),
since a real JAX init compiles op by op for seconds on the CPU."""
import numpy as np

from torch_gan_common import seeded_variables

EMB_HW = (48, 64)
GEN_HW = (32, 48)
EMBEDDING_DATA = {
    "transforms": "pil2np | apply_clahe:1.0 | totensor | normalize",
    "mean_std": [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]],
}
GENERATOR_DATA = {
    "transforms": "pil2np | totensor | normalize",
    "mean_std": [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]],
}
TINY_GENERATOR = {"architecture": "official_resnet_generator", "ngf": 8,
                  "n_blocks": 2, "no_antialias": True,
                  "no_antialias_up": True, "norm_layer": "instance"}
CIRNET = {"architecture": "cirnet", "cir_architecture": "vgg16",
          "pooling": "gem", "local_whitening": False, "whitening": False}


def _shape_variables(module, hw, seed, **kw):
    import jax
    import jax.numpy as jnp
    shapes = jax.eval_shape(
        lambda x: module.init(jax.random.PRNGKey(0), x, **kw),
        jnp.zeros((1,) + tuple(hw) + (3,), jnp.float32))
    return jax.tree_util.tree_map(jnp.asarray,
                                  seeded_variables(dict(shapes), seed))


def embedding_pair(multiscale=True, seed=1, data_params=EMBEDDING_DATA):
    """(JAX HubModel, port HubModel on the CPU): GeM VGG16 with GeM p 3,
    the hub's CLAHE pipeline, the multiscale wrapper (msp 3) when asked."""
    import jax
    from gandtr_tpu.hub import HubModel as JHubModel
    from gandtr_tpu.learning.network import WrappedNet as JWrappedNet
    from gandtr_tpu.learning.wrappers import \
        CirMultiscaleAggregation as JMultiscale
    from gandtr_tpu.models import initialize_model as jinit
    from gandtr_tpu_torch import hub as thub
    from gandtr_tpu_torch.utils.weights import from_jax_variables

    module = jinit(CIRNET)
    variables = _shape_variables(module, (64, 64), seed)
    variables["params"]["gem_p"] = jax.numpy.full((1,), 3.0)
    wrappers = [JMultiscale(scales=True)] if multiscale else []
    net = JWrappedNet(module=module, wrappers_train=[],
                      wrappers_eval=wrappers, meta=module.meta,
                      data_params=dict(data_params))
    jm = JHubModel(net, variables, None, meta={
        **module.meta, "msp": 3.0 if multiscale else 1.0})
    tm = thub._embedding("vgg16", pretrained=False, multiscale=multiscale,
                         device="cpu")
    tm.net.module.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    tm.net.data_params = dict(data_params)
    if not multiscale:
        tm.meta["msp"] = 1.0
    return jm, tm


def generator_pair(seed=2, compute_dtype=None):
    """(JAX HubModel, port HubModel on the CPU): a 2-block ResNet generator
    at ngf 8 (instance norm, reflect padding) on the same weights; the
    port's in `compute_dtype` (bf16 takes K3's op in its blocks)."""
    import jax
    from gandtr_tpu.hub import HubModel as JHubModel
    from gandtr_tpu.learning.network import WrappedNet as JWrappedNet
    from gandtr_tpu.models import initialize_model as jinit
    from gandtr_tpu_torch.hub import HubModel
    from gandtr_tpu_torch.learning.network import WrappedNet
    from gandtr_tpu_torch.models import initialize_model
    from gandtr_tpu_torch.utils.weights import from_jax_variables

    meta = {"in_channels": 3, "out_channels": 3}
    module = jinit(dict(TINY_GENERATOR))
    variables = _shape_variables(module, GEN_HW, seed, train=False)
    jm = JHubModel(JWrappedNet(module=module, meta={},
                               data_params=dict(GENERATOR_DATA)),
                   variables, None, meta=dict(meta))
    tmod = initialize_model(dict(TINY_GENERATOR))
    tmod.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    tmod.eval()
    net = WrappedNet(module=tmod, meta=dict(tmod.meta),
                     data_params=dict(GENERATOR_DATA),
                     compute_dtype=compute_dtype)
    import torch
    return jm, HubModel(net, None, torch.device("cpu"), meta=dict(meta))


def images(n, hw, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n,) + tuple(hw)
                                               + (3,), dtype=np.uint8)
