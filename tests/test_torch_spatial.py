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
  its weights; the BatchNorm's running statistics; on equal and on
  unequal bands;
- the gradient of sum(mac(x) * r) and sum(gem(x) * r) with a dead
  (all-zero) channel, a tie over every band, and a maximum tied across
  the two bands: torch.amax splits it evenly among the tied positions;
- uneven bands (`band_plan`: edges on multiples of the net's total
  downsampling, the last band the rest), on two ranks and on three (a 1 x
  3 grid): the shard / gather round trip at 543 rows, instance norm,
  GeM and SPoC, strided convs whose last band is odd, HED's pool and
  resize, `scale_resize` (its gathered bands bit-equal to the unsharded
  resize), and ResNet's stem conv and padded 3x3 max-pool with their
  gradients.

Float32 throughout; the bound is the JAX spatial test's, rtol 1e-4 and
atol 1e-5 (tests/test_spatial_sharding.py): the bands differ from the
whole only in summation order (a split mean, a conv over fewer rows).
Without a process group: the band plans, `total_downsample` of the four
nets, the input's plan that CLAHE and the multiscale resize need, the
guards (a band thinner than its halo, a last band thinner than
the net's downsampling, a stride that does not divide an inner band)
raise ValueError, and every op of ROADMAP A.6.6 raises
NotImplementedError under a grid.
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
    cases.append(("stack", "stack", {"state": _stack(), "r": _x(seed=65)},
                  _x(seed=64)))
    return cases + _uneven_cases()


def _stack():
    return [_state(layers.Conv, {"in_channels": 3, "features": 4,
                                 "kernel_size": 3}, 60),
            _state(layers.Conv, {"in_channels": 4, "features": 4,
                                 "kernel_size": 3}, 61),
            _state(layers.BatchNorm, {"num_features": 4}, 62),
            _state(layers.ConvTranspose, {"in_channels": 4, "features": 3},
                   63)]


UNEVEN_CONVS = ["k1_s2", "k3_s2", "k7_s2_reflect", "k3_replicate_s2"]
UNEVEN = (["roundtrip_543_d16", "roundtrip_543_d32", "instance_norm_uneven",
           "gem_uneven", "spoc_uneven", "hed_resize_uneven"]
          + ["%s_uneven" % c for c in UNEVEN_CONVS])
SCALES = {"sqrt2": 1 / np.sqrt(2), "half": 0.5}


def _uneven_cases():
    """Cases whose bands differ in rows on two and on three ranks: 21 rows
    at a downsampling of 2 (12 + 9; 8 + 8 + 5), 543 at 16 and 32, 22 rows
    at ResNet's stem's 4 (12 + 10; 8 + 8 + 6). The stack's strided conv
    leaves its training BatchNorm bands of 6 + 5 and 4 + 4 + 3 rows."""
    cases = []
    for d in (16, 32):
        cases.append(("roundtrip_543_d%d" % d, "roundtrip", {"downsample": d},
                      _x(c=2, seed=80, h=543, w=4)))
    two = {"downsample": 2}
    cases.append(("instance_norm_uneven", "instance_norm", two,
                  _x(c=5, seed=81, h=21)))
    cases.append(("gem_uneven", "gem", two, np.abs(_x(c=6, seed=82, h=21))))
    cases.append(("spoc_uneven", "spoc", two, _x(c=6, seed=83, h=21)))
    cases.append(("hed_resize_uneven", "hed_resize", two,
                  _x(c=2, seed=84, h=21)))
    for i, name in enumerate(UNEVEN_CONVS):
        args = dict(CONVS[name], in_channels=3, features=4)
        cases.append((name + "_uneven", "conv", dict(
            two, args=args, state=_state(layers.Conv, args, 90 + i)),
            _x(seed=90 + i, h=21)))
    for name, f in sorted(SCALES.items()):
        cases.append(("scale_resize_" + name, "scale_resize",
                      {"factor": f, "downsample": 16},
                      _x(c=3, seed=95, h=543, w=6)))
    stem = _state(layers.Conv, {"in_channels": 3, "features": 4,
                                "kernel_size": 7, "use_bias": False}, 97)
    cases.append(("stack_uneven", "stack", dict(
        two, state=_stack(), r=_x(seed=67, h=22)), _x(seed=66, h=21)))
    cases.append(("stem", "stem", {"state": [stem], "downsample": 4,
                                   "r": _x(c=4, seed=98, h=6, w=2)},
                  _x(seed=99, h=22, w=8)))
    return cases


def _spawn(n_sp, cases):
    return spawn("spatial_primitives", world=n_sp, cases=cases, n_data=1,
                 n_sp=n_sp), {c[0]: c for c in cases}


@pytest.fixture(scope="module")
def ranks():
    """The two ranks' outputs of every case, and the cases."""
    return _spawn(2, _cases())


@pytest.fixture(scope="module")
def ranks3():
    """Three ranks' outputs of the uneven cases, and the cases."""
    return _spawn(3, _uneven_cases())


@pytest.fixture(params=[2, 3], ids=["2_bands", "3_bands"])
def uneven(request):
    return request.getfixturevalue("ranks" if request.param == 2
                                   else "ranks3")


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


@pytest.mark.parametrize("name", UNEVEN)
def test_uneven_bands(uneven, name):
    """Ops on bands of unequal rows (the last holds the rest) against the
    op on the whole tensor: a round trip gives the input back exactly;
    the means count every band's own positions; a strided conv or pool
    on an odd last band keeps the image's floor rule."""
    outs, cases = uneven
    _, kind, spec, x = cases[name]
    if kind == "roundtrip":
        plan = spatial.band_plan(x.shape[1], len(outs), spec["downsample"])
        assert [o[name]["rows"] for o in outs] == [r for _, r in plan]
        assert len(set(r for _, r in plan)) == 2
        for out in outs:
            assert torch.equal(out[name]["y"], torch.from_numpy(x))
        return
    want = _unsharded(cases[name])
    for out in outs:
        assert out[name].shape == want.shape
        _close(out[name], want)


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_scale_resize_bands_bit_equal(uneven, scale):
    """`scale_resize` of 543-row bands: every band of the result is the
    unsharded resize's rows under the new height's plan, bit for bit."""
    outs, cases = uneven
    name = "scale_resize_" + scale
    want = _unsharded(cases[name])
    assert want.shape[1] == int(543 * SCALES[scale])
    for out in outs:
        assert torch.equal(out[name], want)


def test_resnet_stem_and_max_pool_gradients(uneven):
    """ResNet's 7x7 stride-2 stem conv and padded 3x3 stride-2 max-pool
    on 22-row bands: the last band (10 or 6 rows) turns odd after the
    conv. Output, input gradient and weight gradient (summed over the
    ranks) against the whole tensor's."""
    outs, cases = uneven
    _, kind, spec, x = cases["stem"]
    op = spatial_op(kind, spec)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = op(xt)
    assert y.shape[1] == 6
    (y * torch.from_numpy(spec["r"])).sum().backward()
    for out in outs:
        got = out["stem"]
        _close(got["y"], y.detach())
        _close(got["dx"], xt.grad)
        for g, p in zip(got["dw"], op.parameters()):
            _close(g, p.grad)


def test_stack_gradients(ranks):
    """Output, input gradient, weight gradients (summed over the ranks)
    and the training BatchNorm's running statistics against the stack on
    the whole batch."""
    _check_stack(*ranks, "stack")


def test_uneven_stack_gradients(uneven):
    """The stack on bands of unequal rows: the training BatchNorm counts
    each band's own positions in its batch statistics and in the unbiased
    variance of its running statistics."""
    _check_stack(*uneven, "stack_uneven")


def _check_stack(outs, cases, name):
    _, kind, spec, x = cases[name]
    op = spatial_op(kind, spec)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = op(xt)
    (y * torch.from_numpy(spec["r"])).sum().backward()
    stats = op[5].state_dict()
    for out in outs:
        got = out[name]
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


@pytest.mark.parametrize("height", [None, 48])
def test_input_layers_need_the_plan(height):
    """CLAHE and the multiscale resize read the input image whole and take
    its bands' rows from the plan `sharded` holds: with no input height
    given, or a band that is not the plan's, they raise ValueError."""
    from gandtr_tpu_torch.ops import clahe, resize
    x = torch.zeros(1, 20, 8, 3)
    with spatial.sharded(_fake_grid(), 16, height):
        with pytest.raises(ValueError, match="plan"):
            resize.scale_resize(x, 0.5)
        with pytest.raises(ValueError, match="plan"):
            clahe.channel_clahe(x[..., 0], 4.0, 8)


@pytest.mark.parametrize("H,n_sp,D,rows", [
    (543, 2, 16, (272, 271)), (543, 3, 16, (192, 192, 159)),
    (543, 2, 32, (288, 255)), (90, 2, 16, (48, 42)), (181, 2, 32, (96, 85)),
    (768, 2, 16, (384, 384)), (64, 2, 16, (32, 32))])
def test_band_plan(H, n_sp, D, rows):
    """Each band but the last starts and ends on a multiple of D; halved
    at every depth to D (floor, as VGG16's pools, and ceil, as ResNet's
    padded strides), the bands still add up to the whole image's rows."""
    plan = spatial.band_plan(H, n_sp, D)
    assert tuple(r for _, r in plan) == rows
    assert [f for f, _ in plan] == [sum(rows[:i]) for i in range(n_sp)]
    assert all(f % D == 0 for f, _ in plan)
    floor, ceil = list(rows), list(rows)
    h_floor = h_ceil = H
    while D > 1:
        floor = [r // 2 for r in floor[:-1]] + [floor[-1] // 2]
        ceil = [r // 2 for r in ceil[:-1]] + [-(-ceil[-1] // 2)]
        h_floor, h_ceil, D = h_floor // 2, -(-h_ceil // 2), D // 2
        assert sum(floor) == h_floor and sum(ceil) == h_ceil


@pytest.mark.parametrize("net,want", [("vgg16", 16), ("resnet", 32),
                                      ("generator", 4), ("hed", 16)])
def test_total_downsample(net, want, monkeypatch):
    """Along the main path only: a Bottleneck's strided shortcut runs
    beside its strided conv2 and is not counted again."""
    from gandtr_tpu_torch.models import backbones, initialize_model
    monkeypatch.setitem(backbones.RESNET_LAYERS, "resnet101", (1, 1, 1, 1))
    cfgs = {
        "vgg16": {"architecture": "cirnet", "cir_architecture": "vgg16",
                  "pooling": "gem", "local_whitening": False,
                  "whitening": False},
        "resnet": {"architecture": "cirnet", "cir_architecture": "resnet101",
                   "pooling": "gem", "local_whitening": False,
                   "whitening": False},
        "generator": {"architecture": "official_resnet_generator", "ngf": 8,
                      "n_blocks": 2, "norm_layer": "instance"},
        "hed": {"architecture": "hed_interpolation", "width_mult": 0.125}}
    assert spatial.total_downsample(initialize_model(cfgs[net])) == want


def test_uneven_split_and_bad_world_raise():
    sm = _fake_grid(n_data=2, n_sp=2)
    with pytest.raises(ValueError, match="max_spatial_shards"):
        # bands of 32 + 8 rows: the last thinner than a row at depth 16
        spatial.shard_spatial(torch.zeros(2, 40, 8, 3), sm, downsample=16)
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
    from gandtr_tpu_torch.models import extra_layers, generators
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
        "nearest_resize": lambda: resize.nearest_resize(x, 4, 4),
        "masked_resize": lambda: resize.masked_scale_resize(x, None, 0.5),
        "device_scalecrop": lambda: resize.dynamic_bilinear_resize_u8(
            u8[..., None], hw, 4, 4),
        "global_local": lambda: GlobalLocalModule(None).forward_global(x),
        "grouping": lambda: grouping.Grouping.forward(None, []),
        "patch_sample": lambda: PatchSampleF()([x]),
        "rcf": lambda: rcf.RCF.forward(None, x),
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
