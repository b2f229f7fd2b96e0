"""The hub's multiscale GeM descriptors row-sharded in the port
(gandtr_tpu_torch/parallel/spatial.py) against the same nets in one
process and against the JAX package's GSPMD forward, on the CPU.

Four gloo ranks (tests/torch_dp_workers.py, whose workers import only
the port) form a 2 x 2 data x sp grid and run `spatial_apply` on the
hub's descriptor models with their seeded weights and a seeded Lw:
- `gem_vgg16_hedngan` at multiscale=True (scales 1, 1/sqrt 2, 1/2, the
  GeM-p power mean, Lw) on 128 x 96 inputs: scale 1/sqrt 2 makes 90 rows,
  bands of 48 + 42 (band edges on multiples of VGG16's downsampling 16),
  in float32 and in bf16 (K2's plain version on the halo-extended bands),
  and on uint8 photos through its device preprocessing (LAB CLAHE on each
  data row's gathered image, normalize);
- `gem_resnet101_cyclegan` (always multiscale) on 256 x 64 inputs: 181
  rows at 1/sqrt 2, bands of 96 + 85 (ResNet's downsampling 32; the last
  band turns odd at the stem conv and the max-pool), with seeded frozen
  BatchNorm statistics, at one block a stage in both packages (the
  workers set the port's RESNET_LAYERS; here pytest's monkeypatch sets
  both packages' dicts).

The JAX side runs the same wrapped net (CirtorchWhiten and
CirMultiscaleAggregation through `apply_wrapped`, the hub's GeM p as the
power) jitted once, its input placed `P("data", "sp")` on the conftest's
virtual devices, its weights carried from the port's through the JAX
package's torch importer.

Bounds: the sharded port within rtol 1e-4, atol 1e-5 of the unsharded
port (the JAX spatial test's bound), within 1e-5 of JAX's GSPMD
descriptors (the unsharded descriptor parity bound,
tests/test_torch_models.py), unit norm within 1e-4; bf16 VGG16 within
5e-3 of the unsharded bf16 descriptors (the bf16 descriptor rule,
PERF.md §2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gandtr_tpu.learning import wrappers as jwrappers
from gandtr_tpu.models import backbones as jbackbones
from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch import hub
from gandtr_tpu_torch.models import backbones
from gandtr_tpu_torch.models.layers import FrozenBatchNorm
from torch_dp_workers import spatial_net, spawn

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
JAX_ATOL = 1e-5
NORM_ATOL = 1e-4
BF16_DESC = 5e-3
DEPTH = (1, 1, 1, 1)        # ResNet-101's blocks a stage in this module
GRID = (2, 2)
MODELS = {"vgg16": "gem_vgg16_hedngan", "resnet": "gem_resnet101_cyclegan"}
SIZES = {"vgg16": (128, 96), "resnet": (256, 64)}


@pytest.fixture(scope="module", autouse=True)
def reduced_resnet():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbackbones, backbones):
            mp.setitem(mod.RESNET_LAYERS, "resnet101", DEPTH)
        yield


def _lw(dim, seed):
    rs = np.random.RandomState(seed)
    return {"P": np.linalg.qr(rs.randn(dim, dim))[0].astype(np.float32),
            "m": (rs.randn(dim, 1) * 0.01).astype(np.float32)}


def _resnet_state():
    """The hub ResNet's seeded module with seeded frozen BatchNorm
    statistics and affine parameters (their identity init would leave
    the frozen form untested)."""
    model = hub.gem_resnet101_cyclegan(pretrained=False, device="cpu")
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in model.net.module.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
    return {k: v.clone() for k, v in model.net.module.state_dict().items()}


def _jax_gspmd(arch, state, lw, msp, x):
    """JAX's wrapped descriptor net on the port's weights, jitted once,
    its input sharded P("data", "sp") over a 2 x 2 mesh."""
    cfg = {"architecture": "cirnet", "cir_architecture": arch,
           "pooling": "gem", "local_whitening": False, "whitening": False}
    jnet = j_initialize_model(cfg)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    variables = ti.convert_torch_state(
        template, {k: v.numpy() for k, v in state.items()},
        key_map=ti.retrieval_key_map, min_coverage=1.0)
    wrappers = [jwrappers.CirtorchWhiten(P=lw["P"], m=lw["m"]),
                jwrappers.CirMultiscaleAggregation(scales=True)]
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs the 4-device virtual mesh")
    m = Mesh(np.array(devices[:4]).reshape(GRID), ("data", "sp"))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(m, P("data", "sp")))
    vr = jax.device_put(variables, NamedSharding(m, P()))
    fn = jax.jit(lambda vv, z: jwrappers.apply_wrapped(
        wrappers, lambda t: jnet.apply(vv, t), z, {"msp": msp}),
        out_shardings=NamedSharding(m, P("data")))
    return np.asarray(fn(vr, xs))


@functools.lru_cache(maxsize=None)
def runs():
    """{case: (JAX's sharded output or None, the port's unsharded output,
    each rank's sharded output)}."""
    rs = np.random.RandomState(21)
    xs = {k: (rs.randn(2, h, w, 3) * 0.5).astype(np.float32)
          for k, (h, w) in SIZES.items()}
    u8 = rs.randint(0, 256, (2,) + SIZES["vgg16"] + (3,), dtype=np.uint8)
    lws = {"vgg16": _lw(512, 5), "resnet": _lw(2048, 6)}
    states = {"vgg16": None, "resnet": _resnet_state()}

    def cfg(arch, **kw):
        c = {"hub": MODELS[arch], "lw": lws[arch], "multiscale": True,
             "pre": False}
        c.update(kw)
        return c
    cases = [("vgg16", cfg("vgg16"), None, xs["vgg16"], GRID, "float32"),
             ("vgg16_bf16", cfg("vgg16"), None, xs["vgg16"], GRID,
              "bfloat16"),
             ("vgg16_u8", cfg("vgg16", pre=True), None, u8, GRID, "float32"),
             ("resnet", cfg("resnet", resnet_depth=DEPTH), states["resnet"],
              xs["resnet"], GRID, "float32")]
    ranks = spawn("spatial_nets", world=4, cases=cases)
    out = {}
    for name, c, state, x, _, dtype in cases:
        c = {k: v for k, v in c.items() if k != "resnet_depth"}
        with torch.inference_mode():
            fn = spatial_net(c, state, dtype)
            mine = fn(torch.from_numpy(x)).float().numpy()
        out[name] = [None, mine, [r[name].numpy() for r in ranks]]
        if name in MODELS:
            if state is None:
                state = hub.gem_vgg16_hedngan(
                    pretrained=False, device="cpu").net.module.state_dict()
            msp = float(state["pool.p"][0])
            out[name][0] = _jax_gspmd("vgg16" if name == "vgg16" else
                                      "resnet101", state, lws[name], msp, x)
    return out


@pytest.mark.parametrize("name", ["vgg16", "vgg16_u8", "resnet"])
def test_sharded_multiscale_matches_unsharded(name):
    _, plain, ranks = runs()[name]
    for got in ranks:
        assert got.shape == plain.shape
        np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["vgg16", "resnet"])
def test_sharded_multiscale_matches_jax_gspmd(name):
    want, _, ranks = runs()[name]
    for got in ranks:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("name", ["vgg16", "vgg16_bf16", "vgg16_u8",
                                  "resnet"])
def test_sharded_multiscale_unit_norm(name):
    for got in runs()[name][2]:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=NORM_ATOL)


def test_bf16_multiscale_vgg16_matches_unsharded():
    """K2's plain version on the halo-extended bands of all three scales
    (the last band of 42 rows at 1/sqrt 2) against the unsharded bf16
    net."""
    _, plain, ranks = runs()["vgg16_bf16"]
    for got in ranks:
        assert got.shape == plain.shape
        assert np.abs(got - plain).max() <= BF16_DESC
