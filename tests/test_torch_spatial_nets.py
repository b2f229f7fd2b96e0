"""The three nets of tests/test_spatial_sharding.py row-sharded in the port
(gandtr_tpu_torch/parallel/spatial.py) against the JAX package's GSPMD
forward of the same weights, on the CPU.

The port runs four gloo ranks (tests/torch_dp_workers.py, whose workers
import only the port) through `spatial_apply`; the JAX side runs here, on
the conftest's virtual devices, with the JAX test's shardings:
- the generator of `:23-41` (ngf 8, 2 blocks, instance norm) at 128², H
  sharded 4 ways (`P(None, "sp")`; the port's 1 x 4 grid);
- GeM-VGG16 of `:43-62` at 64² on a 2 x 2 data x sp mesh (`P("data",
  "sp")`), the descriptors unit norm;
- HED of `:100-126` (width 0.125) at 64² through the JAX package's
  `spatial_mesh(2, 2)` and `max_spatial_shards`, `fastconv` restored after.
The weights are the JAX init's, carried over with `from_jax_variables`.

Bounds: each sharded port net within rtol 1e-4, atol 1e-5 of the port's
unsharded forward (the JAX test's bound: the bands differ from the whole
in summation order only); against JAX's sharded forward, the bound of the
port's unsharded parity tests of the same net: the generator 1e-4
(tests/test_torch_generator.py), the descriptors 1e-5
(tests/test_torch_models.py), HED 1e-5 of its sigmoid. GeM-VGG16 again
in bf16 (K2's plain version on the halo-extended bands) within 5e-3 of
the unsharded bf16 descriptors, the bf16 step's descriptor rule
(PERF.md §2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.ops import fastconv
from gandtr_tpu.parallel import mesh as jmesh
from gandtr_tpu_torch.utils.weights import from_jax_variables
from torch_dp_workers import spatial_net, spawn

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
JAX_ATOL = {"generator": 1e-4, "vgg16": 1e-5, "hed": 1e-5}
BF16_DESC = 5e-3
CHAIN_FACTOR = 2.0      # chip_smoke.py's C.2 rule for a bf16 chain

GEN = {"architecture": "official_resnet_generator", "ngf": 8,
       "n_blocks": 2, "norm_layer": "instance"}
VGG = {"architecture": "cirnet", "cir_architecture": "vgg16",
       "pooling": "gem", "local_whitening": False, "whitening": False}
HED = {"architecture": "hed_interpolation", "width_mult": 0.125}


def _devices(n):
    if len(jax.devices()) < n:
        pytest.skip("needs the %d-device virtual mesh" % n)
    return jax.devices()[:n]


def _init(cfg, x, **kw):
    net = j_initialize_model(cfg)
    v = jax.jit(lambda z: net.init(jax.random.PRNGKey(0), z, **kw))(
        jnp.asarray(x[:1]))
    return net, v


def _jax_generator(x):
    gen, v = _init(GEN, x, train=False)
    m = Mesh(np.array(_devices(4)), ("sp",))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(m, P(None, "sp")))
    vr = jax.device_put(v, NamedSharding(m, P()))
    out = jax.jit(lambda vv, z: gen.apply(vv, z, train=False),
                  out_shardings=NamedSharding(m, P(None, "sp")))(vr, xs)
    return v, np.asarray(out)


def _jax_vgg16(x):
    net, v = _init(VGG, x)
    m = Mesh(np.array(_devices(4)).reshape(2, 2), ("data", "sp"))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(m, P("data", "sp")))
    vr = jax.device_put(v, NamedSharding(m, P()))
    out = jax.jit(lambda vv, z: net.apply(vv, z),
                  out_shardings=NamedSharding(m, P("data")))(vr, xs)
    return v, np.asarray(out)


def _jax_hed(x):
    hw = x.shape[1]
    assert jmesh.max_spatial_shards(hw, 16, max_halo=2) == 2
    net, v = _init(HED, x)
    enabled_before = fastconv.ENABLED
    try:
        m = jmesh.spatial_mesh(2, 2, devices=_devices(4))
        xs = jax.device_put(jnp.asarray(x), NamedSharding(m, P("data", "sp")))
        vr = jax.device_put(v, NamedSharding(m, P()))
        out = np.asarray(jax.jit(lambda vv, z: net.apply(vv, z))(vr, xs))
    finally:
        fastconv.set_enabled(enabled_before)
    return v, out


def _x(n, hw, seed):
    return np.random.RandomState(seed).rand(n, hw, hw, 3).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """{net: (JAX's sharded output, the port's unsharded output, each
    rank's sharded output)}, and the bf16 VGG16 pair."""
    xs = {"generator": _x(2, 128, 0) * 2 - 1, "vgg16": _x(4, 64, 1),
          "hed": _x(4, 64, 3)}
    cfgs = {"generator": GEN, "vgg16": VGG, "hed": HED}
    grids = {"generator": (1, 4), "vgg16": (2, 2), "hed": (2, 2)}
    jax_fns = {"generator": _jax_generator, "vgg16": _jax_vgg16,
               "hed": _jax_hed}
    out, cases, states = {}, [], {}
    for name, fn in jax_fns.items():
        v, jout = fn(xs[name])
        states[name] = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                                 v))
        out[name] = [jout]
        cases.append((name, cfgs[name], states[name], xs[name],
                      grids[name], "float32"))
    cases.append(("vgg16_bf16", VGG, states["vgg16"], xs["vgg16"],
                  (2, 2), "bfloat16"))
    cases.append(("generator_bf16", GEN, states["generator"],
                  xs["generator"], (1, 4), "bfloat16"))
    rs = np.random.RandomState(5)
    lw = {"P": np.linalg.qr(rs.randn(512, 512))[0].astype(np.float32),
          "m": (rs.randn(512, 1) * 0.01).astype(np.float32)}
    cases.append(("hub_descriptor", {"hub": "gem_vgg16_hedngan", "lw": lw},
                  None, rs.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8),
                  (2, 2), "float32"))
    ranks = spawn("spatial_nets", world=4, cases=cases)
    out["k3_calls"] = [r["k3_calls"] for r in ranks]
    for name, cfg, state, x, _, dtype in cases:
        with torch.inference_mode():
            mine = spatial_net(cfg, state, dtype)(
                torch.from_numpy(x)).float().numpy()
        out.setdefault(name, [None])
        out[name] += [mine, [r[name].numpy() for r in ranks]]
    return out


@pytest.mark.parametrize("name", ["generator", "vgg16", "hed",
                                  "hub_descriptor"])
def test_sharded_port_matches_unsharded_port(runs, name):
    _, plain, ranks = runs[name]
    for got in ranks:
        assert got.shape == plain.shape
        np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["generator", "vgg16", "hed"])
def test_sharded_port_matches_jax_gspmd(runs, name):
    want, _, ranks = runs[name]
    for got in ranks:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL[name])


def test_sharded_descriptors_unit_norm(runs):
    for got in runs["vgg16"][2] + runs["hub_descriptor"][2]:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-4)


def test_bf16_vgg16_k2_bands_match_unsharded(runs):
    """K2's plain version on the halo-extended bands (cropped) against
    the unsharded bf16 net."""
    _, plain, ranks = runs["vgg16_bf16"]
    for got in ranks:
        assert got.shape == plain.shape
        assert np.abs(got - plain).max() <= BF16_DESC


def test_bf16_generator_chain_without_k3(runs):
    """The bf16 generator under the grid runs its blocks layer by layer
    (K3 declines: no fused-block call on any rank) and stays within
    CHAIN_FACTOR of the unsharded bf16 generator's (K3's plain version
    here) largest distance from the float32 output."""
    f32 = runs["generator"][1]
    _, plain, ranks = runs["generator_bf16"]
    assert all(c["generator_bf16"] == 0 for c in runs["k3_calls"])
    dp = np.abs(plain - f32).max()
    assert dp > 0
    for got in ranks:
        assert np.abs(got - f32).max() <= CHAIN_FACTOR * dp

