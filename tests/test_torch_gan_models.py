"""The port's HED^N-GAN building blocks against the JAX package's, on the CPU
at micro size: BatchNorm's training form, the PatchGAN discriminators and
HED in train and eval mode (weights carried across with
utils/weights.from_jax_variables and back with the JAX importer), the HED
key map of the published sniklaus file, the bilinear resize and the
reflect pad whose backward is fixed-order, HED's input wrappers, the GAN
losses, the lambda schedules and HED's Adam parameter groups."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gandtr_tpu.learning import optimizers as jopt
from gandtr_tpu.learning import schedules as jsched
from gandtr_tpu.learning.wrappers import initialize_wrappers as j_wrappers
from gandtr_tpu.models import initialize_model as j_initialize_model
from gandtr_tpu.models.layers import BatchNorm as JBatchNorm
from gandtr_tpu.ops import losses as JL
from gandtr_tpu.ops.resize import bilinear_resize as j_bilinear_resize
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.learning import optimizers as popt
from gandtr_tpu_torch.learning import schedules as psched
from gandtr_tpu_torch.learning.wrappers import initialize_wrappers
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.layers import BatchNorm, pad2d
from gandtr_tpu_torch.ops import losses as PL
from gandtr_tpu_torch.ops.resize import bilinear_resize
from gandtr_tpu_torch.utils import weights as W
from torch_gan_common import seeded_variables

torch.set_num_threads(1)

MODELS = {
    "nlayer": {"architecture": "official_p2p_discriminator", "ndf": 4,
               "n_layers": 3, "input_nc": 3, "norm_layer": "batch",
               "no_antialias": True},
    "nlayer_instance": {"architecture": "official_p2p_discriminator",
                        "ndf": 4, "n_layers": 2, "norm_layer": "instance",
                        "no_antialias": True},
    "patch": {"architecture": "official_patch_discriminator", "ndf": 4,
              "norm_layer": "batch", "no_antialias": True},
    "hed": {"architecture": "hed_interpolation", "width_mult": 0.0625},
}
HED_WRAPPERS = ("rgb2bgr_pre,meanstd_pre:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:"
                "[[0.40787054,0.45752458,0.48109378],[1.0,1.0,1.0]]")


def _x(shape=(2, 32, 32, 3), seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def _jax_model(name, seed=1):
    """(JAX module, variables): seeded over the init's shapes, running
    statistics away from 0 / 1."""
    jmod = j_initialize_model(dict(MODELS[name]))
    shapes = jax.eval_shape(lambda x: jmod.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((2, 32, 32, 3)))
    v = seeded_variables(dict(shapes), seed)
    if "batch_stats" in v:
        rs = np.random.RandomState(seed + 1)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (rs.randn(*a.shape) * 0.1 if p[-1].key == "mean"
                          else rs.uniform(0.5, 1.5, a.shape))
            .astype(np.float32), v["batch_stats"])
    return jmod, v


def _port_model(name, variables):
    module = initialize_model(dict(MODELS[name]))
    module.load_state_dict(W.from_jax_variables(variables), strict=True)
    return module


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (4, 8, 8, 16)])
def test_batchnorm_train_form_against_jax(shape):
    """Two training forwards: the outputs and the running statistics
    (biased variance normalizes, unbiased moves the statistics, momentum
    0.1) within 1e-6 of the JAX BatchNorm's."""
    C = shape[-1]
    rs = np.random.RandomState(3)
    scale = (1 + 0.2 * rs.randn(C)).astype(np.float32)
    bias = (0.1 * rs.randn(C)).astype(np.float32)
    jbn = JBatchNorm()
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    for i in range(2):
        x = (rs.randn(*shape) * (1 + i) + i).astype(np.float32)
        jy, upd = jbn.apply(v, jnp.asarray(x), use_running_average=False,
                            mutable=["batch_stats"])
        v = {**v, "batch_stats": upd["batch_stats"]}
        y = bn(torch.from_numpy(x))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(v["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(v["batch_stats"]["var"]),
                                   rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == 2


def test_batchnorm_keeps_float32_statistics_for_bf16():
    """A bf16 input is normalized in float32 and moves float32 statistics,
    as its float32 copy does; in eval mode the running statistics
    normalize and do not move."""
    x = torch.from_numpy(_x((2, 6, 6, 4))).to(torch.bfloat16)
    a, b = BatchNorm(4).train(), BatchNorm(4).train()
    ya, yb = a(x), b(x.float())
    assert ya.dtype == torch.float32 and torch.equal(ya, yb)
    assert a.running_var.dtype == torch.float32
    assert torch.equal(a.running_var, b.running_var)
    a.eval()
    before = a.running_mean.clone()
    y = a(x.float())
    assert torch.equal(a.running_mean, before)
    ref = (x.float() - a.running_mean) / torch.sqrt(a.running_var + 1e-5) \
        * a.weight + a.bias
    assert torch.allclose(y, ref.detach())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["nlayer", "nlayer_instance", "patch",
                                  "hed"])
def test_model_against_jax(name, train):
    """float32 outputs within 1e-5 of the JAX model's; in train mode the
    running statistics the forward moved too."""
    jmod, v = _jax_model(name)
    module = _port_model(name, v)
    x = _x()
    has_bn = "batch_stats" in v
    if train and has_bn:
        jy, upd = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    else:
        jy, upd = jax.jit(lambda v, x: jmod.apply(v, x, train=train))(
            v, jnp.asarray(x)), None
    module.train(train)
    with torch.no_grad():
        y = module(torch.from_numpy(x))
    assert y.shape == jy.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    if upd is not None:
        got = module.state_dict()
        want = W.from_jax_variables({"params": v["params"],
                                     "batch_stats": upd["batch_stats"]})
        for k in want:
            if k.endswith("running_mean") or k.endswith("running_var"):
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           rtol=1e-6, atol=1e-6, err_msg=k)


def test_hed_pre_sigmoid_against_jax():
    """`no_sigmoid=True`, the map the student is distilled on."""
    jmod, v = _jax_model("hed")
    module = _port_model("hed", v)
    x = _x((1, 40, 56, 3), seed=2)
    jy = jax.jit(lambda v, x: jmod.apply(v, x, no_sigmoid=True))(
        v, jnp.asarray(x))
    with torch.no_grad():
        y = module(torch.from_numpy(x), no_sigmoid=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert float(np.abs(np.asarray(jy)).max()) > 1e-3


@pytest.mark.parametrize("name", ["nlayer", "patch", "hed"])
def test_state_dict_round_trip_into_jax(name):
    """The port's state dict, through the JAX importer
    (convert_torch_state with the architecture's key map, every leaf
    covered), gives the JAX variables back."""
    jmod, v = _jax_model(name, seed=4)
    module = _port_model(name, v)
    state = ti.torch_state_to_numpy(module.state_dict())
    arch = MODELS[name]["architecture"]
    back = ti.convert_torch_state(
        jax.tree_util.tree_map(jnp.zeros_like, v), state,
        key_map=ti.key_map_for_architecture(arch), min_coverage=1.0)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(v),
                              jax.tree_util.tree_leaves_with_path(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), p


def test_hed_key_map_is_the_jax_one():
    """The port's copy names every HED parameter as the JAX package's
    hed_key_map does, and those are the port module's own names."""
    _, v = _jax_model("hed")
    module = initialize_model(dict(MODELS["hed"]))
    names = set()
    for path, _ in jax.tree_util.tree_leaves_with_path(v["params"]):
        keys = tuple(p.key for p in path)
        assert W.hed_key_map(keys) == ti.hed_key_map(keys), keys
        names.add(W.hed_key_map(keys))
    assert names == set(module.state_dict())


def test_sniklaus_named_file_loads_into_hed(tmp_path):
    """A synthetic sniklaus-named checkpoint (torch layouts under the names
    the JAX importer reads the published hed_sniklaus_github.pth by)
    loads strictly through `load_pretrained`, and the port's HED then
    equals the JAX HED that imported the same file."""
    jmod, v = _jax_model("hed", seed=6)
    state = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        keys = tuple(p.key for p in path)
        a = np.asarray(leaf)
        state[ti.hed_key_map(keys)] = torch.from_numpy(
            a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a.copy())
    path = tmp_path / "hed_sniklaus.pth"
    torch.save(state, path)
    module = W.load_pretrained(initialize_model(dict(MODELS["hed"])),
                               str(path))
    jv = ti.convert_torch_state(jax.tree_util.tree_map(jnp.zeros_like, v),
                                ti.torch_state_to_numpy(state),
                                key_map=ti.hed_key_map, min_coverage=1.0)
    x = _x(seed=7)
    with torch.no_grad():
        y = module(torch.from_numpy(x))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax.jit(jmod.apply)(jv, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    del state["fusion.0.bias"]
    torch.save(state, path)
    with pytest.raises(RuntimeError, match="fusion.0.bias"):
        W.load_pretrained(initialize_model(dict(MODELS["hed"])), str(path))


@pytest.mark.parametrize("url", [
    "http://ptak.felk.cvut.cz/personal/jenicto2/download/iccv23_gan/"
    "hed_sniklaus_github.pth", "https://host/hed.pth"])
def test_pretrained_url_is_refused(url):
    with pytest.raises(NotImplementedError, match="downloads nothing"):
        W.load_pretrained(initialize_model(dict(MODELS["hed"])), url)


def test_pretrained_null_keeps_the_weights():
    module = initialize_model(dict(MODELS["hed"]))
    before = {k: v.clone() for k, v in module.state_dict().items()}
    for value in (None, False, True):
        W.load_pretrained(module, value)
    assert all(torch.equal(before[k], v)
               for k, v in module.state_dict().items())


@pytest.mark.parametrize("name", ["nlayer", "patch"])
def test_antialiased_discriminator_is_refused(name):
    """No longer refused: the blur-pool discriminator builds, each
    stride-2 step a stride-1 conv and a BlurDownsample of `model`
    (tests/test_torch_architectures.py holds it to JAX's)."""
    from gandtr_tpu_torch.models.layers import BlurDownsample
    net = initialize_model({**MODELS[name], "no_antialias": False})
    seq = (net.d if name == "patch" else net).model
    blurs = [i for i, m in enumerate(seq) if isinstance(m, BlurDownsample)]
    assert blurs == ([2, 6] if name == "patch" else [2, 6, 10])
    assert all(seq[i - 1].__class__.__name__ == "LeakyReLU" for i in blurs)


@pytest.mark.parametrize("size", [(32, 32), (256, 192), (40, 56), (7, 5)])
def test_bilinear_resize_against_jax(size):
    """The matrix-product resize within 1e-6 of the JAX package's gather
    form and of F.interpolate; its gradient equals F.interpolate's."""
    x = _x((2, 16, 12, 1), seed=8)
    y = bilinear_resize(torch.from_numpy(x), *size)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(j_bilinear_resize(jnp.asarray(x), *size)),
        atol=1e-6)
    xt = torch.from_numpy(x).requires_grad_(True)
    xr = torch.from_numpy(x).requires_grad_(True)
    g = torch.from_numpy(_x((2,) + size + (1,), seed=9))
    (bilinear_resize(xt, *size) * g).sum().backward()
    ref = F.interpolate(xr.permute(0, 3, 1, 2), size=size, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ref.detach().numpy(), y.numpy(), atol=1e-6)
    (ref * g).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_pad_with_autograd_equals_f_pad(pad):
    """The flipped-slice reflect pad equals F.pad's, forward bit for bit
    (with and without autograd recording) and backward within float
    rounding."""
    x = torch.from_numpy(_x((2, 9, 11, 4), seed=10))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    yb = F.pad(b.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
    ref = yb.detach().permute(0, 2, 3, 1)
    with torch.no_grad():
        y0 = pad2d(x, pad, "reflect")
    assert torch.equal(y0, ref) and y0.is_contiguous()
    y = pad2d(a, pad, "reflect")
    assert torch.equal(y.detach(), ref) and y.is_contiguous()
    g = torch.from_numpy(_x(tuple(y.shape), seed=11))
    (y * g).sum().backward()
    (yb * g.permute(0, 3, 1, 2)).sum().backward()
    assert torch.allclose(a.grad, b.grad, atol=1e-6)


def test_hed_input_wrappers_against_jax():
    """rgb2bgr_pre then meanstd_pre with train_hedngan.yml's arguments."""
    x = _x(seed=12)
    jy = jnp.asarray(x)
    for w in j_wrappers(HED_WRAPPERS):
        jy, _ = w.pre(jy, {})
    y = torch.from_numpy(x)
    for w in initialize_wrappers(HED_WRAPPERS):
        y, _ = w.pre(y, {})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    assert [type(w).__name__ for w in initialize_wrappers(HED_WRAPPERS)] \
        == ["RgbToBgrPre", "MeanStdPre"]


def test_l1_tie_takes_no_gradient():
    """torch's subgradient 0 at a tie (the JAX package routes it there
    explicitly), the sign elsewhere."""
    x = torch.zeros(4, requires_grad=True)
    PL.l1_loss(x, torch.zeros(4)).backward()
    assert x.grad.abs().max().item() == 0.0
    y = torch.tensor([3.0, -2.0], requires_grad=True)
    PL.l1_loss(y, torch.zeros(2)).backward()
    assert y.grad.tolist() == [0.5, -0.5]
    g = jax.grad(lambda v: JL.l1_loss(v, jnp.zeros(4)))(jnp.zeros(4))
    assert float(jnp.abs(g).max()) == 0.0


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("as_list", [False, True])
def test_discriminator_loss_against_jax(real, as_list):
    """mse against the inverted targets (real -> 0, fake -> 1), and the
    multiscale list form with its layer<k> partials."""
    outs = [_x((2, 3, 3, 1), seed=13), _x((2, 2, 2, 1), seed=14)]
    arg = outs if as_list else outs[0]
    jt, jp = JL.discriminator_loss(
        [jnp.asarray(o) for o in outs] if as_list else jnp.asarray(arg),
        real, JL.mse_loss)
    pt, pp = PL.discriminator_loss(
        [torch.from_numpy(o) for o in outs] if as_list
        else torch.from_numpy(arg), real, PL.mse_loss)
    np.testing.assert_allclose(float(pt), float(jt), rtol=1e-6)
    assert sorted(pp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(float(pp[k]), float(jp[k]), rtol=1e-6)


@pytest.mark.parametrize("cfg", [
    {"algorithm": "lambda_p2p", "n_epochs_decay": 25},
    {"algorithm": "lambda", "fixed_ratio": 0.5}])
def test_gan_schedules_against_jax(cfg):
    """The factor of every zero-based epoch of 50, as the JAX Training
    calls them for 1-based epochs."""
    p = psched.initialize_schedule(50, dict(cfg))
    j = jsched.initialize_schedule(50, dict(cfg))
    assert [p(e - 1) for e in range(1, 51)] == [j(e - 1) for e in
                                                range(1, 51)]
    if cfg["algorithm"] == "lambda_p2p":
        assert p(0) == p(24) == 1.0 and p(49) == pytest.approx(1 / 26)


def test_hed_parameter_groups_against_jax():
    """HED's per-layer lr and decay multipliers: the JAX package's table
    for each parameter, by the shared key map."""
    _, v = _jax_model("hed")
    module = _port_model("hed", v)
    jl, jw = jopt.param_group_mults("hed_interpolation", v["params"])
    want = {}
    for (path, lr), (_, wd) in zip(jax.tree_util.tree_leaves_with_path(jl),
                                   jax.tree_util.tree_leaves_with_path(jw)):
        want[W.hed_key_map(tuple(p.key for p in path))] = (lr, wd)
    got = {}
    by_id = {id(p): k for k, p in module.named_parameters()}
    for lr, wd, ps in popt.param_groups("hed_interpolation",
                                        module.named_parameters()):
        for p in ps:
            got[by_id[id(p)]] = (lr, wd)
    assert got == want
    assert {v for v in got.values()} == {
        (1.0, 1.0), (2.0, 0.0), (100.0, 1.0), (200.0, 0.0), (0.01, 1.0),
        (0.02, 0.0), (0.001, 1.0), (0.002, 0.0)}


def test_hed_adam_against_optax():
    """Two Adam steps of the detector's optimizer (lr 1e-6, beta1 0.9,
    weight decay 2e-4, HED's groups; torch Adam's coupled L2) on the same
    gradients: the parameters within 1e-8 (1e-4 of vgg5's step of 2e-4)
    + 1e-6 of their size of the JAX chain's."""
    _, v = _jax_model("hed")
    module = _port_model("hed", v)
    cfg = {"algorithm": "adam", "lr": 1e-6, "beta1": 0.9, "beta2": 0.999,
           "weight_decay": 0.0002}
    opt, base = popt.initialize_optimizer(dict(cfg),
                                          module.named_parameters(),
                                          "hed_interpolation")
    tx, _ = jopt.initialize_optimizer(
        dict(cfg), group_mults=jopt.param_group_mults("hed_interpolation",
                                                      v["params"]))
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = tx.init(params)
    rs = np.random.RandomState(15)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)),
            params)
        gsd = W.from_jax_variables({"params": grads})
        for k, p in module.named_parameters():
            p.grad = gsd[k].clone()
        opt.step()
        upd, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    want = W.from_jax_variables({"params": params})
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
    assert base == 1e-6
