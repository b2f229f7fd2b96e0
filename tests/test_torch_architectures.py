"""The port's generator-side architectures against the JAX package's, on
the CPU, on the same weights (JAX variables filled by shape from a seeded
draw and carried across with utils/weights.from_jax_variables) and the same
seeded inputs: the blur-pool layers, the blur-pool generator and
discriminators, the ResNet encoder -> decoder chain, pix2pix's U-Net
generator. The seven U-Nets of models/unet.py and the CycleGAN step with
the U-Net are in test_torch_architectures_unet.py, the CUT step with
blur-pool G and D in test_torch_architectures_cut.py (each file builds one
JAX GAN, so `--dist loadfile` runs them apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gandtr_tpu.learning.network import WrappedNet as JWrappedNet
from gandtr_tpu.models import initialize_model as j_model
from gandtr_tpu.models import layers as jlayers
from gandtr_tpu.ops import resblock_pallas as rp
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch import hub
from gandtr_tpu_torch.learning.network import WrappedNet
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.layers import (BlurDownsample, BlurUpsample,
                                            pad2d)
from gandtr_tpu_torch.ops import resblock
from gandtr_tpu_torch.utils.weights import from_jax_variables
from torch_gan_common import seeded_variables

torch.set_num_threads(1)

SIDE = 32


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def _jax_net(cfg, x, seed=3, **init_kw):
    """The JAX net of `cfg` with seeded values (running statistics drawn
    too), and the port's net with the same weights, in eval mode."""
    jnet = j_model(dict(cfg))
    shapes = jax.eval_shape(
        lambda x: jnet.init(jax.random.PRNGKey(0), x, **init_kw), x)
    v = seeded_variables(dict(shapes), seed)
    if "batch_stats" in v:
        rs = np.random.RandomState(seed + 1)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (rs.randn(*a.shape) * 0.1 if p[-1].key == "mean"
                          else rs.uniform(0.5, 1.5, a.shape))
            .astype(np.float32), v["batch_stats"])
    v = jax.tree_util.tree_map(jnp.asarray, v)
    net = initialize_model(dict(cfg))
    net.load_state_dict(from_jax_variables(_host(v)), strict=True)
    return jnet, v, net.eval()


# ---- the blur-pool layers and pads


def test_replicate_pad_with_autograd_equals_f_pad():
    """The slice-built replicate pad (top, bottom, left, right) equals
    F.pad(mode="replicate") bit for bit; its gradient sums an edge pixel's
    terms in another (fixed) order: within 1e-6."""
    x = _x((2, 5, 7, 3))
    pad = (1, 2, 3, 0)
    a = torch.from_numpy(x).requires_grad_(True)
    b = torch.from_numpy(x).requires_grad_(True)
    ya = pad2d(a, pad, "repl")
    yb = F.pad(b.permute(0, 3, 1, 2), (3, 0, 1, 2),
               mode="replicate").permute(0, 2, 3, 1)
    assert torch.equal(ya, yb)
    g = torch.from_numpy(_x(tuple(ya.shape), seed=1))
    ya.backward(g)
    yb.backward(g)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["down", "up"])
@pytest.mark.parametrize("fs", [1, 2, 3, 4, 5, 6, 7])
def test_blur_layers_against_jax(fs, kind):
    """BlurDownsample and BlurUpsample at filter sizes 1 to 7: values within
    1e-6 of the JAX layers, input gradients (autograd against jax.vjp)
    within 1e-5; the `filt` buffer is the reference's (C, 1, k, k)."""
    C = 3
    x = _x((2, 9, 11, C), seed=fs)
    if kind == "down":
        jm, tm = jlayers.BlurDownsample(filt_size=fs), BlurDownsample(C, fs)
    else:
        jm, tm = jlayers.BlurUpsample(filt_size=fs), BlurUpsample(C, fs)
    assert tuple(tm.filt.shape) == (C, 1, fs, fs)
    want, vjp = jax.vjp(lambda v: jm.apply({}, v), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    g = _x(want.shape, seed=10 + fs)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=0, atol=1e-5)


# ---- the generators and discriminators

NETS = {
    "blur_resnet": {"architecture": "official_resnet_generator", "ngf": 8,
                    "n_blocks": 2, "no_antialias": False,
                    "no_antialias_up": False},
    "encoder_decoder": {"architecture": "official_resnet_encoder", "ngf": 8,
                        "n_blocks": 2},
    "unet": {"architecture": "official_unet_generator", "ngf": 8,
             "num_downs": 5},
}


def _decoder_cfg(norm):
    return {**NETS["encoder_decoder"], "architecture":
            "official_resnet_decoder", "norm_type": norm}


def _cfg(name, norm):
    key = "norm_type" if name == "encoder_decoder" else "norm_layer"
    return {**NETS[name], key: norm}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_f32_generators_against_jax(name, norm, train):
    """The blur-pool ResNet generator, the encoder -> decoder chain and
    pix2pix's U-Net (ngf 8, 2 blocks or 5 levels, 32x32, batch 2), float32,
    with instance and batch norm, in eval and train mode: the output within
    1e-4 of JAX's; in train mode with batch norm the running statistics
    too (1e-5)."""
    side = SIDE if name == "unet" else 16
    x = _x((2, side, side, 3), seed=4)
    jx = jnp.asarray(x)
    nets = [_jax_net(_cfg(name, norm), jx, train=False)]
    if name == "encoder_decoder":
        h = jax.eval_shape(lambda v: nets[0][0].apply(v, jx, train=False),
                           nets[0][1])
        nets.append(_jax_net(_decoder_cfg(norm),
                             jnp.zeros(h.shape, jnp.float32), seed=5,
                             train=False))
    want, got, stats = jx, torch.from_numpy(x), []
    for jnet, v, net in nets:
        net.train(train)
        if train:
            want, upd = jnet.apply(v, want, train=True,
                                   mutable=["batch_stats"])
            stats.append((upd, v, net))
        else:
            want = jnet.apply(v, want, train=False)
        with torch.no_grad():
            got = net(got)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    for upd, v, net in stats:
        if norm != "batch":
            assert not upd
            continue
        sd = net.state_dict()
        for k, a in from_jax_variables(_host({"params": v["params"],
                                              **upd})).items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), a.numpy(), rtol=0,
                                           atol=1e-5, err_msg=k)


def test_blur_generator_taps_against_jax():
    """CUT's PatchNCE taps of the blur-pool generator (9 blocks, ngf 4):
    upstream CUT's nce_layers 0, 4, 8, 12, 16 count the blur steps; each
    tap within 1e-4 of JAX's, with and without encode_only."""
    cfg = {**NETS["blur_resnet"], "ngf": 4, "n_blocks": 9,
           "norm_layer": "instance"}
    x = _x((2, SIDE, SIDE, 3), seed=6)
    jnet, v, net = _jax_net(cfg, jnp.asarray(x))
    layers = (0, 4, 8, 12, 16)
    assert type(net.model[7]).__name__ == "BlurDownsample"
    assert type(net.model[21]).__name__ == "BlurUpsample"
    for encode_only in (True, False):
        jout = jnet.apply(v, jnp.asarray(x), layers=layers,
                          encode_only=encode_only, train=True)
        with torch.no_grad():
            out = net(torch.from_numpy(x), layers=layers,
                      encode_only=encode_only)
        if not encode_only:
            (jy, jout), (y, out) = jout, out
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                       atol=1e-4)
        assert len(out) == len(jout) == len(layers)
        for a, b in zip(jout, out):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-4)


def test_bf16_blur_generator_against_jax(monkeypatch):
    """compute_dtype bf16, one block of C = 128 (ngf 32), 32x32: the port's
    blocks through K3's plain version against the JAX generator with its
    Pallas block interpreted. The JAX blur layers take a float32 filter
    that `lax.conv_general_dilated` refuses beside a bf16 input (ROADMAP
    C); the port takes the filter in the input's dtype, and the JAX side
    here gets the same bf16 filter. Bounds: max 0.06, mean 0.01."""
    cfg = {**NETS["blur_resnet"], "ngf": 32, "n_blocks": 1,
           "norm_layer": "instance"}
    x = _x((1, SIDE, SIDE, 3), seed=7)
    jnet, v, net = _jax_net(cfg, jnp.asarray(x))
    orig = jlayers._binomial_filter
    monkeypatch.setattr(jlayers, "_binomial_filter",
                        lambda s: orig(s).astype(jnp.bfloat16))
    rp.set_enabled(True)
    rp.set_force_interpret(True)
    try:
        want = np.asarray(JWrappedNet(module=jnet, compute_dtype=jnp.bfloat16)
                          .apply(v, jnp.asarray(x), train=False))
    finally:
        rp.set_enabled(False)
        rp.set_force_interpret(False)
    calls = []
    plain = resblock.fused_resblock
    monkeypatch.setattr(resblock, "fused_resblock",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    with torch.inference_mode():
        got = WrappedNet(module=net, compute_dtype=torch.bfloat16).apply(
            torch.from_numpy(x))
    assert len(calls) == 1 and got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want.astype(np.float32))
    assert d.max() < 0.06 and d.mean() < 0.01


def test_masked_blur_generator_is_refused():
    """The masked (padded-bucket) mode has no blur-pool form, in either
    package."""
    net = initialize_model({**NETS["blur_resnet"], "norm_layer": "instance"})
    x = torch.zeros(1, SIDE, SIDE, 3)
    with pytest.raises(NotImplementedError, match="blur-pool"):
        net.eval()(x, mask=torch.ones(1, SIDE, SIDE))


@pytest.mark.parametrize("name", ["official_p2p_discriminator",
                                  "official_patch_discriminator"])
def test_blur_discriminators_against_jax(name):
    """The blur-pool NLayer and patch discriminators (ndf 8, batch norm,
    train mode) within 1e-4 of JAX's."""
    cfg = {"architecture": name, "ndf": 8, "no_antialias": False,
           "norm_layer": "batch"}
    x = _x((2, SIDE, SIDE, 3), seed=8)
    jnet, v, net = _jax_net(cfg, jnp.asarray(x), train=False)
    want, _ = jnet.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = net.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["blur_resnet", "encoder_decoder"])
def test_state_dict_through_the_jax_importer(name):
    """The encoder's state_dict loads into the JAX net through the JAX
    importer's default key map, every leaf filled, and comes back equal;
    so does the blur-pool generator's without its `filt` buffers, which
    the importer's strict check counts as unused keys (ROADMAP C)."""
    x = jnp.zeros((1, 16, 16, 3))
    _, v, net = _jax_net(_cfg(name, "batch"), x, train=False)
    sd = {k: t.numpy() for k, t in net.state_dict().items()}
    filt = [k for k in sd if k.endswith(".filt")]
    assert len(filt) == (4 if name == "blur_resnet" else 0)
    if filt:
        with pytest.raises(KeyError, match="filt"):
            ti.convert_torch_state(_host(v), sd)
    back = ti.convert_torch_state(
        _host(v), {k: a for k, a in sd.items() if k not in filt},
        min_coverage=1.0)
    for k, t in from_jax_variables(_host(back)).items():
        np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)


@pytest.mark.parametrize("size,scale", [((13, 50), None), ((41, 29), 2.5)])
def test_resizes_against_jax(size, scale):
    """nearest_resize and bilinear_resize (to a size, and with `scale`,
    F.interpolate(scale_factor=...)'s coordinates) within 1e-6 of the JAX
    package's; nearest_resize equals F.interpolate(mode="nearest")."""
    from gandtr_tpu.ops import resize as jresize
    from gandtr_tpu_torch.ops.resize import bilinear_resize, nearest_resize
    x = _x((2, 20, 14, 3), seed=12)
    t = torch.from_numpy(x)
    got = bilinear_resize(t, *size, scale=scale)
    want = jresize.bilinear_resize(jnp.asarray(x), *size, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    got = nearest_resize(t, *size)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jresize.nearest_resize(jnp.asarray(x),
                                                       *size)))
    ref = F.interpolate(t.permute(0, 3, 1, 2), size=size, mode="nearest")
    assert torch.equal(got, ref.permute(0, 2, 3, 1))


@pytest.mark.parametrize("arch", ["identity", "normalization_l2"])
def test_identity_and_normalization_l2_against_jax(arch):
    x = _x((2, 5, 4, 3), seed=13)
    jnet = j_model({"architecture": arch})
    want = jnet.apply({}, jnp.asarray(x))
    got = initialize_model({"architecture": arch})(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    assert dict(jnet.meta) == dict(initialize_model(
        {"architecture": arch}).meta)


# ---- the hub, and the GAN builds' helper


def test_hub_adopts_a_blur_pool_checkpoint(tmp_path):
    """hub.cyclegan on a checkpoint whose network_params name a blur-pool
    generator builds that generator and loads it strictly."""
    cfg = {**NETS["blur_resnet"], "ngf": 4, "n_blocks": 2,
           "norm_layer": "instance", "input_nc": 3, "output_nc": 3}
    net = initialize_model(dict(cfg))
    path = str(tmp_path / "g.pth")
    torch.save({"network_params": {"model": cfg},
                "model_state": net.state_dict()}, path)
    gen = hub.cyclegan(pretrained=True, checkpoint=path, device="cpu")
    assert any(isinstance(m, BlurDownsample) for m in gen.net.module.modules())
    for k, t in net.state_dict().items():
        assert torch.equal(gen.net.module.state_dict()[k], t), k


def _gan_pair(section, root, mp):
    """The JAX GAN experiment of `section` (nets by shape, seeded), and
    the port's from the same initial weights (local `pretrained:` files)."""
    import gandtr_tpu.scenarios.build as jbuild
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    from test_torch_gan_train import _with_initial_weights
    from torch_gan_common import shape_init, without_data
    shape_init(mp)
    jexp = jbuild.build_gan_experiment(without_data(section), sample_hw=SIDE)
    psec = _with_initial_weights(section, root, jexp["variables"])
    return jexp, build_gan_experiment(without_data(psec), device="cpu")
