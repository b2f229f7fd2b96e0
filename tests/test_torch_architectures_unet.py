"""The port's U-Net generators against the JAX package's, on the CPU, on
the same weights and seeded inputs (split from
test_torch_architectures.py, whose helpers it uses): pix2pix's U-Net
generator's names and dropout, the seven U-Nets of models/unet.py, and
the CycleGAN step that builds the U-Net generator."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.layers import Dropout
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_architectures import SIDE, _cfg, _gan_pair, _host, _jax_net, _x

torch.set_num_threads(1)


def test_unet_generator_names_and_the_jax_importer():
    """pix2pix's nested names (`model.model.1.model.3...`), the ones a
    reference `.pth` holds; the JAX importer's default key map has no
    entry for them (ROADMAP C), so it refuses a port state_dict."""
    cfg = _cfg("unet", "batch")
    x = jnp.zeros((1, SIDE, SIDE, 3))
    jnet, v, net = _jax_net(cfg, x, train=False)
    sd = net.state_dict()
    for k in ("model.model.0.weight", "model.model.3.bias",
              "model.model.1.model.1.weight", "model.model.1.model.2.weight",
              "model.model.1.model.3.model.3.model.3.model.1.weight",
              "model.model.1.model.3.model.3.model.3.model.4.running_var"):
        assert k in sd, k
    assert "model.model.0.bias" not in sd    # batch norm: no conv bias
    with pytest.raises(KeyError):
        ti.convert_torch_state(_host(v), {k: t.numpy()
                                          for k, t in sd.items()})


def test_unet_dropout_draws_from_its_generator():
    """The U-Net's dropout draws from the net's own CPU generator: two runs
    from the same generator state agree, and about half of a block's
    outputs are dropped; in eval mode it is the identity."""
    net = initialize_model({**_cfg("unet", "instance"), "num_downs": 6,
                            "use_dropout": True}).train()
    drops = [m for m in net.modules() if isinstance(m, Dropout)]
    assert len(drops) == 1 and drops[0].generator is net.generator
    x = torch.from_numpy(_x((1, 64, 64, 3), seed=9))
    state = net.generator.get_state()
    with torch.no_grad():
        a = net(x)
        net.generator.set_state(state)
        b = net(x)
        c = net(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    h = torch.ones(4000)
    d = Dropout(0.5, torch.Generator().manual_seed(1)).train()(h)
    assert 0.45 < (d == 0).float().mean() < 0.55
    assert set(d.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(drops[0].eval()(h), h)


VARIANTS = [
    ("orig_unet", {"nested_levels": 2, "min_channels": 4}),
    ("p2p_unet", {"nested_levels": 2}),
    ("shallow_p2p_unet", {"nested_levels": 2}),
    ("outconv_unet", {"nested_levels": 2}),
    ("outconv_dynint_unet", {"nested_levels": 2}),
    ("inconv_p2p_unet", {"nested_levels": 2}),
    ("aligned_p2p_unet", {"nested_levels": 2}),
]


@pytest.mark.parametrize("arch,kw", VARIANTS, ids=[a for a, _ in VARIANTS])
def test_unet_variants_against_jax(arch, kw):
    """The seven U-Nets at tests/test_model_variants.py's sizes (32x32):
    eval mode within 1e-4 of JAX's; their state_dict loads into the JAX
    net through the JAX importer's default key map, every leaf filled,
    and comes back equal."""
    cfg = {"architecture": arch, "in_channels": 3, "out_channels": 3, **kw}
    x = _x((1, SIDE, SIDE, 3), seed=11)
    jnet, v, net = _jax_net(cfg, jnp.asarray(x), train=False)
    want = jnet.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    sd = {k: t.numpy() for k, t in net.state_dict().items()}
    back = ti.convert_torch_state(_host(v), sd, min_coverage=1.0)
    for k, t in from_jax_variables(_host(back)).items():
        np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)



def test_cyclegan_step_with_unet_against_jax(tmp_path):
    """train_cyclegan.yml at test_torch_cyclegan.py's micro size with
    pix2pix's U-Net (`official_unet_generator`, ngf 4, 5 levels, batch
    norm: unet_256's form) for both generators: one step through
    `build_cyclegan_step`, each loss within 1e-3 relative, the fakes and
    reconstructions within 1e-4, each network's gradients (Adam's first
    moment) within test_torch_cyclegan.py's GRAD_RTOL, or below its
    ZERO_GRAD in both where they are 0 in exact arithmetic."""
    from test_torch_cyclegan import (GRAD_RTOL, METRICS, ZERO_GRAD,
                                     _gradients, micro_cyclegan_config)
    cfg = micro_cyclegan_config(str(tmp_path))
    unet = {"architecture": "official_unet_generator", "input_nc": 3,
            "output_nc": 3, "ngf": 4, "num_downs": 5, "norm_layer": "batch"}
    for name in ("generator_X", "generator_Y"):
        cfg["network"][name]["model"] = dict(unet)
    with pytest.MonkeyPatch.context() as mp:
        jexp, exp = _gan_pair(cfg, str(tmp_path), mp)
    rs = np.random.RandomState(0)
    X, Y = (rs.uniform(-1, 1, (2, SIDE, SIDE, 3)).astype(np.float32)
            for _ in range(2))
    jstate, jm, jdbg = jexp["step"](jexp["state"], jnp.asarray(X),
                                    jnp.asarray(Y))
    state, pm, pdbg = exp["step"](exp["state"], torch.from_numpy(X),
                                  torch.from_numpy(Y))
    for k in METRICS:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-3,
                                   err_msg=k)
    for k in ("fake_Y", "rec_X", "fake_X", "rec_Y"):
        np.testing.assert_allclose(pdbg[k].numpy(), np.asarray(jdbg[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert type(exp["models"]["generator_X"].module).__name__ == \
        "UnetGenerator"
    for name, grads in _gradients(jstate, exp).items():
        net = float(torch.cat([w.flatten() for _, w in grads.values()])
                    .norm())
        for key, (got, want) in grads.items():
            if float(want.norm()) < ZERO_GRAD * net:
                assert float(got.norm()) < ZERO_GRAD * net, (name, key)
                continue
            rel = float((got - want).norm() / want.norm())
            assert rel <= GRAD_RTOL, (name, key, rel)
