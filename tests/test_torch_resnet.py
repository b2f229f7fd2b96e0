"""The port's GeM ResNet descriptor net (models/backbones.py, the frozen
BatchNorm of models/layers.py, the poolings, the weight mapping, the
optimizer groups, the hub entries) against the JAX package, on the CPU.

The weights are the port's seeded ones (BatchNorm given seeded running
statistics, so that the frozen form is exercised), carried into the JAX
variables through the JAX package's torch importer (`convert_torch_state`);
the JAX variables are made by shape (`jax.eval_shape`): a JAX init of
ResNet-101 compiles for a long time. Full-depth ResNet-101 runs op by op
on the JAX side at 64x64; the pooling and BatchNorm tests run a
reduced-depth ResNet of blocks (1, 1, 2, 1), added to both packages'
RESNET_LAYERS and OUTPUT_DIM under a test-only name for the module's tests
(`RESNET_T`, the `reduced_resnet` fixture; tests/test_torch_finetune_r101.py
and tests/test_torch_whitening.py use it too).

Tolerances: 1e-4 on unit-norm float32 descriptors (about 100 convs and
BatchNorms, summed in other orders by XLA and by PyTorch on the CPU; the
VGG16 net is held at 1e-5), 1e-5 for the port's bucketed forward against
its exact-shape one."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.learning import wrappers as jwrappers
from gandtr_tpu.learning.optimizers import param_group_mults
from gandtr_tpu.models import backbones as jbackbones
from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.ops import pooling as jpool
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch import hub
from gandtr_tpu_torch.learning import wrappers as twrappers
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.learning.optimizers import param_groups
from gandtr_tpu_torch.models import backbones
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.layers import FrozenBatchNorm
from gandtr_tpu_torch.ops import pooling as tpool
from gandtr_tpu_torch.ops.norm import batch_norm_inference
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_exact_bucketing import SHAPES
from test_torch_finetune import _torch

torch.set_num_threads(1)

RESNET_T = "resnet_t"           # the reduced-depth ResNet of the step test
MODEL = {"architecture": "cirnet", "cir_architecture": "resnet101",
         "pooling": "gem", "local_whitening": False, "whitening": False,
         "regional": False}
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def reduced_resnet():
    """RESNET_T in both packages' tables for this module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbackbones, backbones):
            mp.setitem(mod.RESNET_LAYERS, RESNET_T, (1, 1, 2, 1))
            mp.setitem(mod.OUTPUT_DIM, RESNET_T, 2048)
        yield


def seeded_net(model=MODEL, seed=0):
    """The port's net with seeded weights (hub._init_random) and seeded
    BatchNorm running statistics and affine parameters."""
    net = initialize_model(model)
    hub._init_random(net, seed)
    g = torch.Generator().manual_seed(seed + 7)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
    return net


def jax_template(model):
    return _jax_template(tuple(sorted(model.items())))


@functools.lru_cache(maxsize=None)
def _jax_template(items):
    jnet = j_initialize_model(dict(items))
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    return jnet, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


def to_jax(template, net):
    return ti.convert_torch_state(
        template, {k: v.numpy() for k, v in net.state_dict().items()},
        key_map=ti.retrieval_key_map, min_coverage=1.0)


@functools.lru_cache(maxsize=None)
def r101_pair():
    """(JAX net, its variables, the port's net) on the same weights."""
    net = seeded_net().eval()
    jnet, template = jax_template(MODEL)
    return jnet, to_jax(template, net), net


def _x(shape, n=2, seed=0):
    return np.random.RandomState(seed).randn(n, *shape, 3).astype(np.float32)


def _bucketed(imgs, B=64):
    xb = np.zeros((len(imgs), B, B, 3), np.float32)
    mb = np.zeros((len(imgs), B, B), np.float32)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        xb[i, :h, :w] = im
        mb[i, :h, :w] = 1.0
    return xb, mb


@functools.lru_cache(maxsize=None)
def bucketed_runs():
    """SHAPES' images in one 64 bucket: the JAX masked descriptors, the
    port's masked ones and the port's exact-shape ones."""
    jnet, variables, net = r101_pair()
    rng = np.random.RandomState(7)
    imgs = [rng.randn(h, w, 3).astype(np.float32) for h, w in SHAPES]
    xb, mb = _bucketed(imgs)
    want = np.asarray(jnet.apply(variables, jnp.asarray(xb),
                                 mask=jnp.asarray(mb)))
    with torch.inference_mode():
        got = net(*_torch(xb, mb)).numpy()
        exact = np.concatenate([net(torch.from_numpy(im[None])).numpy()
                                for im in imgs])
    return want, got, exact


# ---- ResNet-101 against the JAX net

def test_features_match_jax():
    """The backbone's (N, 2, 2, 2048) features of 64x64 inputs, relative
    to their largest magnitude (the seeded net's features grow with depth;
    the descriptors are normalized)."""
    jnet, variables, net = r101_pair()
    x = _x((64, 64))
    feats = jbackbones.ResNetFeatures(arch="resnet101")
    want = np.asarray(feats.apply(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]},
        jnp.asarray(x)))
    with torch.inference_mode():
        got = net.features(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 2, 2, 2048)
    np.testing.assert_allclose(got / np.abs(want).max(),
                               want / np.abs(want).max(), atol=TOL, rtol=0)


def test_descriptors_match_jax():
    jnet, variables, net = r101_pair()
    x = _x((64, 64))
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_bucketed_descriptors_match_jax(i):
    """Each image of SHAPES padded into a 64 bucket with its mask: the
    port's masked descriptor and its exact-shape one against the JAX
    net's masked descriptor (which tests/test_exact_bucketing.py holds to
    the JAX exact one within 1e-6)."""
    want, got, exact = bucketed_runs()
    np.testing.assert_allclose(got[i], want[i], atol=TOL, rtol=0)
    np.testing.assert_allclose(exact[i], want[i], atol=TOL, rtol=0)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_port_bucketed_equals_exact(i):
    _, got, exact = bucketed_runs()
    np.testing.assert_allclose(got[i], exact[i], atol=1e-5, rtol=0)


def test_feature_mask_and_band():
    """The masked backbone returns each image's valid (h, w) at stride 32
    (torch's floor rule through conv1, the max pool and the strided
    blocks) and a zero band."""
    _, _, net = r101_pair()
    xb, mb = _bucketed([_x(s, n=1)[0] for s in [(64, 33), (17, 61)]])
    with torch.inference_mode():
        feats, fmask = net.features(
            torch.from_numpy(xb).permute(0, 3, 1, 2),
            mask=torch.from_numpy(mb))
    assert fmask.shape == (2, 2, 2)
    assert fmask[0].tolist() == [[1, 1], [1, 1]]
    assert fmask[1].tolist() == [[1, 1], [0, 0]]
    assert not feats[1, :, 1].any()


# ---- poolings

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["mac", "spoc", "gem", "gemmp"])
def test_pooling_matches_jax(name, masked):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 7, 6).astype(np.float32) * 2
    if name.startswith("gem"):
        x = np.abs(x)
    mask = None
    if masked:
        mask = np.zeros((3, 5, 7), np.float32)
        for i, (h, w) in enumerate([(5, 7), (3, 4), (1, 2)]):
            mask[i, :h, :w] = 1.0
    p = {"gem": np.float32(2.5),
         "gemmp": rng.uniform(1.5, 4, 6).astype(np.float32)}.get(name)
    jfn = jpool.gem if p is not None else getattr(jpool, name)
    tfn = tpool.gem if p is not None else getattr(tpool, name)
    jkw = {} if p is None else {"p": jnp.asarray(p)}
    tkw = {} if p is None else {"p": torch.from_numpy(np.asarray(p))}
    want = np.asarray(jfn(jnp.asarray(x), mask=None if mask is None
                          else jnp.asarray(mask), **jkw))
    got = tfn(torch.from_numpy(x), mask=None if mask is None
              else torch.from_numpy(mask), **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if masked:   # a masked row equals the pooling of its crop
        crop = tfn(torch.from_numpy(x[1:2, :3, :4].copy()), **tkw).numpy()
        np.testing.assert_allclose(got[1:2], crop, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pooling", ["gemmp", "mac", "spoc"])
def test_pooled_net_matches_jax(pooling):
    """A reduced-depth ResNet with each non-GeM pooling, masked in a 64
    bucket, against the JAX net; gemmp's (2048,) p crosses as `pool.p`."""
    model = dict(MODEL, cir_architecture=RESNET_T, pooling=pooling)
    net = seeded_net(model)
    if pooling == "gemmp":
        with torch.no_grad():
            net.pool.p.copy_(torch.linspace(2.0, 4.0, 2048))
    jnet, template = jax_template(model)
    variables = to_jax(template, net.eval())
    xb, mb = _bucketed([_x(s, n=1, seed=5)[0] for s in [(64, 40), (37, 64)]])
    want = np.asarray(jnet.apply(variables, jnp.asarray(xb),
                                 mask=jnp.asarray(mb)))
    with torch.inference_mode():
        got = net(*_torch(xb, mb)).numpy()
    assert net.meta["pooling"] == pooling and net.meta["out_channels"] == 2048
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("pooling", ["gem", "gemmp"])
def test_multiscale_msp_on_resnet_equals_jax(pooling):
    """The multiscale power of a ResNet net: GeM's p, and 1 for gemmp."""
    model = dict(MODEL, cir_architecture=RESNET_T, pooling=pooling)
    net = seeded_net(model)
    with torch.no_grad():
        net.pool.p.fill_(2.5)
    _, template = jax_template(model)
    want = jwrappers.multiscale_msp(model, to_jax(template, net))
    assert twrappers.multiscale_msp(model, net) == want == \
        (2.5 if pooling == "gem" else 1.0)


def test_regional_is_refused():
    """A regional ResNet net builds (Rpool over GeM, a 2048-d regional
    whitening) and is refused in the padded-bucket (masked) mode only."""
    net = initialize_model(dict(MODEL, regional=True))
    assert tuple(net.pool.whiten.weight.shape) == (2048, 2048)
    with pytest.raises(ValueError, match="regional"):
        net.pool(torch.ones(1, 3, 3, 2048), mask=torch.ones(1, 3, 3))


# ---- weights, both ways

def test_weights_roundtrip_port_to_jax_and_back():
    """The port's state -> the JAX importer (key_map_for_architecture
    ("cirnet")) -> from_jax_variables: the same keys and arrays, BatchNorm
    statistics included, loading strict."""
    net = seeded_net(dict(MODEL, whitening=True))
    _, template = jax_template(dict(MODEL, whitening=True))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    variables = ti.convert_torch_state(
        template, state, key_map=ti.key_map_for_architecture("cirnet"),
        strict=True, min_coverage=1.0)
    back = from_jax_variables(variables)
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k].numpy(), state[k], err_msg=k)
    initialize_model(dict(MODEL, whitening=True)).load_state_dict(
        back, strict=True)


def test_weights_roundtrip_jax_to_port_and_back():
    """Seeded JAX variables -> from_jax_variables -> strict into the port's
    net -> the JAX importer: the same arrays, leaf for leaf."""
    _, template = jax_template(MODEL)
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(a.dtype), template)
    net = initialize_model(MODEL)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    back = to_jax(template, net)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    # 104 convs, 104 BatchNorms of 4 arrays, GeM p
    assert len(flat_a) == len(flat_b) == 104 + 4 * 104 + 1
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_state_dict_names_are_torchvision_s():
    names = set(initialize_model(MODEL).state_dict())
    for key in ("features.0.weight", "features.1.running_var",
                "features.4.0.downsample.0.weight",
                "features.4.0.downsample.1.bias",
                "features.6.22.conv3.weight", "features.7.2.bn3.weight",
                "features.7.0.conv2.weight", "pool.p"):
        assert key in names, key
    assert not any(".fc." in k or k.startswith("features.8") for k in names)
    assert initialize_model(MODEL).features[7][0].conv2.stride == (2, 2)


# ---- the optimizer's groups

def test_optimizer_groups_equal_jax():
    """The cirnet table on ResNet-101: GeM p at lr x10 and weight decay 0,
    everything else (BatchNorm affine included) x1, leaf for leaf as the
    JAX package's param_group_mults."""
    jnet, variables, net = r101_pair()
    lr, wd = param_group_mults("cirnet", variables["params"])
    want = {}
    for (path, lm), (_, wm) in zip(
            jax.tree_util.tree_leaves_with_path(lr),
            jax.tree_util.tree_leaves_with_path(wd)):
        keys = tuple(getattr(e, "key", str(e)) for e in path)
        want[ti.retrieval_key_map(keys)] = (float(lm), float(wm))
    names = {id(p): k for k, p in net.named_parameters()}
    got = {names[id(p)]: (lm, wm)
           for lm, wm, ps in param_groups("cirnet", net.named_parameters())
           for p in ps}
    assert got == want
    assert got["pool.p"] == (10.0, 0.0)
    assert got["features.5.0.bn2.bias"] == (1.0, 1.0)


# ---- the frozen BatchNorm

def test_frozen_batchnorm_in_training_mode():
    """`.train()` neither switches the BNs to batch statistics nor updates
    the running ones; the affine weight and bias take gradients; the
    output is the frozen eval form (equal in eval and train mode)."""
    net = seeded_net(dict(MODEL, cir_architecture=RESNET_T))
    stats = {k: v.clone() for k, v in net.named_buffers()}
    x = torch.from_numpy(_x((48, 40)))
    net.eval()
    with torch.no_grad():
        want = net(x)
    net.train()
    y = net(x)
    assert torch.equal(y.detach(), want)
    y.pow(2).sum().backward()
    for k, v in net.named_buffers():
        assert torch.equal(v, stats[k]), k
    bn = net.features[5][0].bn2
    assert bn.weight.grad is not None and bn.weight.grad.abs().sum() > 0
    assert bn.bias.grad is not None and bn.bias.grad.abs().sum() > 0


def test_batch_norm_inference_is_differentiable():
    """torch.autograd.gradcheck in x, weight and bias (float64)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 5, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.rand(5, dtype=torch.float64, generator=g, requires_grad=True)
    b = torch.randn(5, dtype=torch.float64, generator=g, requires_grad=True)
    mean = torch.randn(5, dtype=torch.float64, generator=g)
    var = torch.rand(5, dtype=torch.float64, generator=g) + 0.5
    assert torch.autograd.gradcheck(
        lambda x, w, b: batch_norm_inference(x, mean, var, w, b), (x, w, b))


def test_bf16_policy_runs_float32_after_bn1():
    """Under a bf16 compute dtype the float32 running statistics promote
    bn1's output, so the backbone's features and the descriptor are
    float32, as in the JAX package (its BatchNorm and Conv promote)."""
    net = build_single_net({"model": dict(MODEL, cir_architecture=RESNET_T),
                            "runtime": {"dtype": "bfloat16"}})
    hub._init_random(net.module, 0)
    x = torch.from_numpy(_x((40, 40)))
    for train in (False, True):
        out = net.apply(x, train=train)
        assert out.dtype == torch.float32, train
    assert all(p.dtype == torch.float32 for p in net.module.parameters())


# ---- the hub

@pytest.mark.parametrize("entry", ["gem_resnet101_cyclegan",
                                   "gem_resnet101_hedngan"])
def test_hub_entries_on_the_cpu(entry, tmp_path):
    """Seeded: 2048-d unit-norm multiscale descriptors; with a local
    checkpoint (strict) and a 2048x2048 Lw: the checkpoint's weights."""
    model = getattr(hub, entry)(pretrained=False, device="cpu")
    img = np.random.RandomState(0).randint(0, 256, (70, 90, 3), np.uint8)
    d = model(model.transform(img)[None]).numpy()
    assert d.shape == (1, 2048) and model.meta["out_channels"] == 2048
    np.testing.assert_allclose(np.linalg.norm(d), 1.0, atol=1e-5)

    net = seeded_net(seed=3)
    torch.save({"model_state": net.state_dict(),
                "network_params": {"model": MODEL}}, tmp_path / "net.pth")
    rng = np.random.RandomState(2)
    lw = {"P": (np.eye(2048) + 0.01 * rng.randn(2048, 2048)).astype(
        np.float32), "m": (rng.randn(2048, 1) * 0.01).astype(np.float32)}
    loaded = getattr(hub, entry)(pretrained=True, device="cpu",
                                 checkpoint=str(tmp_path / "net.pth"),
                                 whitening=lw)
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.net.module.state_dict()[k], v), k
    d = loaded(loaded.transform(img)[None]).numpy()
    assert d.shape == (1, 2048) and np.isfinite(d).all()
    with pytest.raises(RuntimeError, match="Missing key"):
        bad = {k: v for k, v in net.state_dict().items()
               if "bn3" not in k}
        torch.save({"model_state": bad}, tmp_path / "bad.pth")
        getattr(hub, entry)(pretrained=True, device="cpu",
                            checkpoint=str(tmp_path / "bad.pth"))
