"""The port's spatial sharding primitives (gandtr_tpu_torch/parallel/
spatial.py) against the same ops unsharded, on the CPU: two gloo ranks
(tests/torch_dp_workers.py, whose workers import only the port) hold the
two bands of a 1 x 2 data x spatial grid, and each op's gathered output
is held against the op on the whole tensor in this process.

- `halo_rows` in every pad mode against the padded image's rows;
- `Conv` at k 1 / 3 / 7, stride 1 / 2, dilation 2, in zero, reflect and
  replicate padding, and after a `Pad`; `ConvTranspose` at k 3, s 2,
  p 1, op 1; instance norm; gem, mac, spoc; the bilinear resize;
- the gradient of sum(y * r) through a small stack (reflect pad, conv,
  instance norm, a strided replicate-padded conv, a training BatchNorm, a
  transposed conv) with respect to its input and, summed over the ranks,
  its weights; the BatchNorm's running statistics;
- the gradient of sum(mac(x) * r) and sum(gem(x) * r) with a dead
  (all-zero) channel, a tie over every band, and a maximum tied across
  the two bands: torch.amax splits it evenly among the tied positions.

Float32 throughout; the bound is the JAX spatial test's, rtol 1e-4 and
atol 1e-5 (tests/test_spatial_sharding.py): the bands differ from the
whole only in summation order (a split mean, a conv over fewer rows).
Without a process group: the guards (a band thinner than its halo, an
uneven split, a stride that does not divide the band) raise ValueError,
and every op of ROADMAP A.6.6 raises NotImplementedError under a grid.
"""
import numpy as np
import pytest
import torch

from gandtr_tpu_torch.models import layers
from gandtr_tpu_torch.parallel import mesh, spatial
from torch_dp_workers import spatial_op, spawn

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
N, H, W = 2, 16, 12


def _x(c=3, seed=0, h=H, w=W):
    return np.random.RandomState(seed).uniform(
        -1, 1, (N, h, w, c)).astype(np.float32)


def _state(cls, args, seed):
    """Seeded weights (and nonzero biases) for a layer."""
    torch.manual_seed(seed)
    m = cls(**args)
    with torch.no_grad():
        for p in m.parameters():
            p.uniform_(-0.5, 0.5)
    return {k: v.clone() for k, v in m.state_dict().items()}


CONVS = {  # name: Conv arguments (in 3, out 4)
    "k1": dict(kernel_size=1),
    "k1_s2": dict(kernel_size=1, stride=2),
    "k3": dict(kernel_size=3, padding=1),
    "k3_s2": dict(kernel_size=3, stride=2, padding=1),
    "k3_reflect": dict(kernel_size=3, padding=1, pad_mode="reflect"),
    "k3_replicate_s2": dict(kernel_size=3, stride=2, padding=1,
                            pad_mode="replicate"),
    "k7": dict(kernel_size=7, padding=3),
    "k7_s2_reflect": dict(kernel_size=7, stride=2, padding=3,
                          pad_mode="reflect"),
    "k3_d2": dict(kernel_size=3, padding=2, dilation=2),
    "k4_s2": dict(kernel_size=4, stride=2, padding=1),
}
PAD_CONVS = {"pad3_reflect_k7": (3, "reflect", 7),
             "pad1_reflect_k3": (1, "reflect", 3),
             "pad1_replicate_k3": (1, "replicate", 3)}
HALOS = [(1, 1), (3, 3), (2, 0), (0, 2)]
HALO_MODES = ["zero", "reflect", "replicate", None]
POOLS = ["gem", "mac", "spoc"]
POOL_GRADS = ["mac", "gem"]
RESIZES = {"up2": 2.0, "down2": 0.5, "up3": 3.0}


def _cases():
    cases = []
    for (lo, hi) in HALOS:
        for mode in HALO_MODES:
            cases.append(("halo_%d_%d_%s" % (lo, hi, mode), "halo",
                          {"lo": lo, "hi": hi, "mode": mode}, _x()))
    for i, (name, args) in enumerate(sorted(CONVS.items())):
        args = dict(args, in_channels=3, features=4)
        cases.append((name, "conv", {"args": args,
                                     "state": _state(layers.Conv, args, i)},
                      _x(seed=i)))
    for i, (name, (pad, mode, k)) in enumerate(sorted(PAD_CONVS.items())):
        args = dict(in_channels=3, features=4, kernel_size=k)
        cases.append((name, "pad_conv", {
            "pad": pad, "mode": mode, "args": args,
            "state": _state(layers.Conv, args, 20 + i)}, _x(seed=20 + i)))
    args = dict(in_channels=3, features=4, kernel_size=3, stride=2,
                padding=1, output_padding=1)
    cases.append(("convt_k3_s2", "convt", {
        "args": args, "state": _state(layers.ConvTranspose, args, 30)},
        _x(seed=30)))
    cases.append(("instance_norm", "instance_norm", {}, _x(c=5, seed=31)))
    for i, name in enumerate(POOLS):
        x = _x(c=6, seed=40 + i)
        cases.append((name, name, {}, np.abs(x) if name == "gem" else x))
    for i, (name, f) in enumerate(sorted(RESIZES.items())):
        cases.append(("resize_" + name, "resize", {"factor": f},
                      _x(c=2, seed=50 + i)))
    for i, name in enumerate(POOL_GRADS):
        x = np.maximum(_x(c=4, seed=70 + i), 0.0)
        x[..., 0] = 0.0                         # dead channel
        x[:, 3, :, 1] = x[:, H - 4, :, 1] = 5.0  # tied across the bands
        r = np.random.RandomState(75 + i).uniform(-1, 1, (N, 4)).astype(
            np.float32)
        cases.append((name + "_grad", "pool_grad", {"pool": name, "r": r},
                      x))
    stack = [_state(layers.Conv, {"in_channels": 3, "features": 4,
                                  "kernel_size": 3}, 60),
             _state(layers.Conv, {"in_channels": 4, "features": 4,
                                  "kernel_size": 3}, 61),
             _state(layers.BatchNorm, {"num_features": 4}, 62),
             _state(layers.ConvTranspose, {"in_channels": 4, "features": 3},
                    63)]
    cases.append(("stack", "stack", {"state": stack, "r": _x(seed=65)},
                  _x(seed=64)))
    return cases


@pytest.fixture(scope="module")
def ranks():
    """The two ranks' outputs of every case, and the cases."""
    cases = _cases()
    return spawn("spatial_primitives", world=2, cases=cases, n_data=1,
                 n_sp=2), {c[0]: c for c in cases}


def _padded_rows(x, lo, hi, mode):
    """The whole image padded by lo rows above and hi below (no rows for
    mode None): the rows every band's halo must reproduce."""
    t = torch.from_numpy(x)
    if mode is None:
        return t, 0
    pad = layers.pad2d(t, (lo, hi, 0, 0), mode)
    return pad, lo


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", HALO_MODES)
@pytest.mark.parametrize("lo,hi", HALOS)
def test_halo_rows(ranks, lo, hi, mode):
    """Each band extended by its halo equals the padded image's rows, bit
    for bit (rows are copied, never computed)."""
    outs, cases = ranks
    name = "halo_%d_%d_%s" % (lo, hi, mode)
    padded, off = _padded_rows(cases[name][3], lo, hi, mode)
    rows = H // 2
    for r, out in enumerate(outs):
        got = out[name]
        top = lo if (mode is not None or r > 0) else 0
        bottom = hi if (mode is not None or r < 1) else 0
        start = off + r * rows - top
        assert got.shape[1] == rows + top + bottom
        assert torch.equal(got, padded[:, start:start + got.shape[1]])


def _unsharded(case):
    name, kind, spec, x = case
    with torch.no_grad():
        return spatial_op(kind, spec)(torch.from_numpy(x))


@pytest.mark.parametrize("name", sorted(CONVS) + sorted(PAD_CONVS)
                         + ["convt_k3_s2"])
def test_convolutions(ranks, name):
    outs, cases = ranks
    want = _unsharded(cases[name])
    for out in outs:
        assert out[name].shape == want.shape
        _close(out[name], want)


@pytest.mark.parametrize("name", ["instance_norm"] + POOLS
                         + ["resize_" + n for n in sorted(RESIZES)])
def test_reductions_and_resize(ranks, name):
    outs, cases = ranks
    want = _unsharded(cases[name])
    for out in outs:
        assert out[name].shape == want.shape
        _close(out[name], want)


def test_stack_gradients(ranks):
    """Output, input gradient, weight gradients (summed over the ranks)
    and the training BatchNorm's running statistics against the stack on
    the whole batch."""
    outs, cases = ranks
    _, kind, spec, x = cases["stack"]
    op = spatial_op(kind, spec)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = op(xt)
    (y * torch.from_numpy(spec["r"])).sum().backward()
    stats = op[5].state_dict()
    for out in outs:
        got = out["stack"]
        _close(got["y"], y.detach())
        _close(got["dx"], xt.grad)
        for g, p in zip(got["dw"], op.parameters()):
            _close(g, p.grad)
        for k, v in stats.items():
            _close(got["stats"][k], v)


@pytest.mark.parametrize("pool", POOL_GRADS)
def test_pool_gradients_with_ties(ranks, pool):
    """The pooled descriptor and its input gradient against the pooling
    of the whole batch: a dead channel's gradient is spread over the whole
    image, as torch.amax spreads it, not given whole to each band."""
    from gandtr_tpu_torch.ops import pooling
    outs, cases = ranks
    _, _, spec, x = cases[pool + "_grad"]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pooling.POOLINGS[pool](xt)
    (y * torch.from_numpy(spec["r"])).sum().backward()
    for out in outs:
        got = out[pool + "_grad"]
        _close(got["y"], y.detach())
        _close(got["dx"], xt.grad)


def _fake_grid(n_data=1, n_sp=2, sp_index=0):
    """A grid object without a process group: enough for the guards, which
    raise before any exchange."""
    sm = spatial.SpatialMesh.__new__(spatial.SpatialMesh)
    sm.n_data, sm.n_sp, sm.world = n_data, n_sp, n_data * n_sp
    sm.rank, sm.data_index, sm.sp_index = sp_index, 0, sp_index
    sm.sp_group = sm.data_group = None
    return sm


@pytest.mark.parametrize("make,rows", [
    (lambda: layers.Conv(3, 4, 7, padding=3), 2),
    (lambda: torch.nn.Sequential(layers.Pad(3, "reflect"),
                                 layers.Conv(3, 4, 7)), 3),
    (lambda: layers.Conv(3, 4, 3, stride=2, padding=1), 5),
])
def test_thin_or_uneven_band_raises(make, rows):
    """Hazard 2: a band thinner than its halo (or, for reflect, not
    thicker), or a stride that does not divide the band, raises
    ValueError naming max_spatial_shards."""
    x = torch.zeros(1, rows, 8, 3)
    with spatial.sharded(_fake_grid()), \
            pytest.raises(ValueError, match="max_spatial_shards"):
        make()(x)


def test_uneven_split_and_bad_world_raise():
    sm = _fake_grid(n_data=2, n_sp=2)
    with pytest.raises(ValueError, match="max_spatial_shards"):
        spatial.shard_spatial(torch.zeros(2, 48, 8, 3), sm, downsample=16)
    with pytest.raises(ValueError, match="batch 3"):
        spatial.shard_spatial(torch.zeros(3, 64, 8, 3), sm)
    with pytest.raises(ValueError, match="process group of 4"):
        mesh.spatial_mesh(2, 2)
    one = mesh.spatial_mesh(1, 1)
    assert (one.n_data, one.n_sp, one.sp_index) == (1, 1, 0)
    x = torch.arange(24.0).reshape(1, 2, 3, 4)
    assert torch.equal(spatial.spatial_apply(lambda t: t * 2, x, one), x * 2)


def _refused_ops():
    """Each op of ROADMAP A.6.6 on a small input; the refusal comes first,
    so the modules' own forwards are called unbound where building the
    module would cost more than the call."""
    from gandtr_tpu_torch.learning.network import GlobalLocalModule
    from gandtr_tpu_torch.learning.wrappers import ReflectPadMakeDivisible
    from gandtr_tpu_torch.models import backbones, extra_layers, generators
    from gandtr_tpu_torch.models import grouping, rcf, unet
    from gandtr_tpu_torch.models.patchsample import PatchSampleF
    from gandtr_tpu_torch.ops import clahe, pooling, resize
    from gandtr_tpu_torch.ops.maskprop import MaskState
    x = torch.rand(1, 8, 8, 3)
    u8 = torch.zeros(1, 8, 8, dtype=torch.uint8)
    hw = torch.tensor([[8, 8]], dtype=torch.int32)
    ops = {
        "mask": lambda: MaskState.maybe(torch.ones(1, 8, 8)),
        "k4": lambda: clahe.clahe_u8_masked(u8, hw),
        "blur_down": lambda: layers.BlurDownsample(3)(x),
        "blur_up": lambda: layers.BlurUpsample(3)(x),
        "unet_generator": lambda: generators.UnetGenerator.forward(None, x),
        "rmac": lambda: pooling.rmac(x),
        "rpool": lambda: pooling.rpool(x, pooling.mac),
        "attention": lambda: extra_layers.l2norm_attention(x),
        "edge_filter": lambda: extra_layers.EdgeFilter()(x),
        "geometric_median": lambda: extra_layers.geometric_median_weiszfeld(
            x),
        "multiscale": lambda: resize.scale_resize(x, 0.5),
        "nearest_resize": lambda: resize.nearest_resize(x, 4, 4),
        "global_local": lambda: GlobalLocalModule(None).forward_global(x),
        "grouping": lambda: grouping.Grouping.forward(None, []),
        "patch_sample": lambda: PatchSampleF()([x]),
        "rcf": lambda: rcf.RCF.forward(None, x),
        "resnet_features": lambda: backbones.ResNetFeatures.forward(
            None, x.permute(0, 3, 1, 2)),
        "reflectpad_divisible": lambda: ReflectPadMakeDivisible(4).pre(x,
                                                                       {}),
    }
    for name in ("OrigUNet", "P2pUNet", "ShallowP2pUNet", "OutconvP2pUNet",
                 "OutconvP2pUNetDynamicInterpolate", "InconvP2pUNet",
                 "AlignedP2pUNet"):
        ops["unet_" + name] = (lambda cls: lambda: cls.forward(None, x))(
            getattr(unet, name))
    return ops


@pytest.mark.parametrize("name", sorted(_refused_ops()))
def test_refused_under_a_grid(name):
    """Every op of ROADMAP A.6.6 raises under a row-sharded grid."""
    op = _refused_ops()[name]
    with spatial.sharded(_fake_grid()), \
            pytest.raises(NotImplementedError, match="A.6.6"):
        op()


def test_k3_declines_under_a_grid():
    """K3's dispatch rule (ops/resblock.py::eligible): its instance-norm
    statistics cover only the rows it is given, so it declines under a
    row-sharded grid, and only there."""
    from gandtr_tpu_torch.ops import resblock
    args = dict(train=False, use_dropout=False, padding_type="reflect",
                norm_type="instance", use_bias=True)
    assert resblock.eligible((1, 8, 8, 16), torch.bfloat16, **args)
    with spatial.sharded(_fake_grid()):
        assert not resblock.eligible((1, 8, 8, 16), torch.bfloat16, **args)
    with spatial.sharded(_fake_grid(n_data=2, n_sp=1)):
        assert resblock.eligible((1, 8, 8, 16), torch.bfloat16, **args)
