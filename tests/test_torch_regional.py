"""The port's descriptor-side architectures against the JAX package's, on
the CPU, on the same weights and seeded inputs: the R-MAC region grid,
rmac and Rpool, the regional GeM net, the R-MAC net, the attention net,
the edge-filter net (cirnet_inchan) and the geometric-median net
(GeM-VGG16 at 64x64), the edge filter's gradients, the cirnet labels'
parameter groups and multiscale power, and a cirnet_inchan fine-tune tuple
step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.learning import supervised as jsup
from gandtr_tpu.learning import wrappers as jwrappers
from gandtr_tpu.learning.network import build_single_net as j_build
from gandtr_tpu.learning.optimizers import param_group_mults
from gandtr_tpu.models import extra_layers as jextra
from gandtr_tpu.models import initialize_model as j_model
from gandtr_tpu.ops import pooling as jpool
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.learning import supervised
from gandtr_tpu_torch.learning import wrappers
from gandtr_tpu_torch.learning.network import build_single_net
from gandtr_tpu_torch.learning.optimizers import (initialize_optimizer,
                                                  param_groups)
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.models.extra_layers import (
    EdgeFilter, HordeCascadedKOrder, weighted_geometric_median_weiszfeld)
from gandtr_tpu_torch.ops import pooling
from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_finetune import ADAM, _batch, _criterion, _grab_grads, _torch
from torch_gan_common import seeded_variables

torch.set_num_threads(1)

HW = 64


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _img(n=2, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, HW, HW, 3)) \
        .astype(np.float32)


def _jax_net(cfg, seed=1):
    """The JAX net of `cfg` with seeded values (GeM p 3, the edge filter at
    its init), and the port's with the same weights."""
    jnet = j_model(dict(cfg))
    shapes = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, HW, HW, 3)))
    v = seeded_variables(dict(shapes), seed)

    def fix(path, a):
        name = getattr(path[-1], "key", "")
        if name == "gem_p":
            return np.full(a.shape, 3.0, np.float32)
        if name == "p":
            return np.full(a.shape, 0.5, np.float32)
        if name == "tau":
            return np.full(a.shape, 0.1, np.float32)
        if name == "bias":      # the whitening heads: not the identity
            return (np.random.RandomState(seed).randn(*a.shape) * 0.01) \
                .astype(np.float32)
        return a
    v = jax.tree_util.tree_map(jnp.asarray,
                               jax.tree_util.tree_map_with_path(fix, v))
    net = initialize_model(dict(cfg))
    net.load_state_dict(from_jax_variables(_host(v)), strict=True)
    return jnet, v, net.eval()


# ---- the regional pooling ops


def test_rmac_regions_equal_jax_for_every_size_to_64():
    """The region grid equals JAX's for every (H, W) in 1..64 x 1..64."""
    for h in range(1, 65):
        for w in range(1, 65):
            assert pooling._rmac_regions(w, h) == jpool._rmac_regions(w, h), \
                (h, w)


def test_rmac_regions_float32_tie_at_18_by_10():
    """H=18, W=10: the region count's argmin over the steps 2..7 ties
    (0.2 at steps 2 and 3); float32 takes step 2 as the JAX package (and
    cirtorch's float32 tensors) do, one region row more than the square
    grid at each level (2 + 6 + 12 regions), where float64 takes step 3
    (3 + 8 + 15)."""
    got = pooling._rmac_regions(10, 18)
    assert got == jpool._rmac_regions(10, 18)
    assert len(got) == 2 + 6 + 12


@pytest.mark.parametrize("hw", [(7, 7), (18, 10), (9, 23), (1, 4)])
def test_rmac_and_rpool_against_jax(hw):
    """rmac and rpool (GeM p 3 over each region, a seeded whitening) within
    1e-5 of JAX's on seeded non-negative features."""
    x = np.abs(np.random.RandomState(hw[0]).randn(2, *hw, 16)) \
        .astype(np.float32)
    W = np.random.RandomState(1).randn(16, 16).astype(np.float32) * 0.3
    b = np.random.RandomState(2).randn(16).astype(np.float32) * 0.1
    t = torch.from_numpy(x)
    np.testing.assert_allclose(pooling.rmac(t).numpy(),
                               np.asarray(jpool.rmac(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    got = pooling.rpool(t, lambda f: pooling.gem(f, p=3.0),
                        whiten_fn=lambda o: o @ torch.from_numpy(W)
                        + torch.from_numpy(b))
    want = jpool.rpool(jnp.asarray(x), lambda f: jpool.gem(f, p=3.0),
                       whiten_fn=lambda o: o @ W + b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---- the descriptor nets and extra layers

VGG = {"architecture": "cirnet", "cir_architecture": "vgg16"}
NETS = {
    "regional_gem": {**VGG, "pooling": "gem", "regional": True},
    "rmac": {**VGG, "pooling": "rmac"},
    "attention": {"architecture": "cirnet_attention",
                  "cir_architecture": "vgg16", "pooling": "gem",
                  "attention": {"type": "l2norm"}},
    "edge_filter": {"architecture": "cirnet_inchan",
                    "cir_architecture": "vgg16", "pooling": "gem",
                    "whitening": True,
                    "inputs": {"preprocessing": {"type": "edgefilter"}}},
    "geometric_median": {**VGG, "pooling": {
        "type": "GeometricMedianWeiszfeld", "iterations": 3}},
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_descriptor_nets_against_jax(name):
    """VGG16 at 64x64, seeded weights: descriptors within 1e-5 of JAX's
    and of unit norm. The state_dict loads into the JAX net through
    `key_map_for_architecture`'s retrieval map and comes back equal, but
    for two faults of that map (ROADMAP C): it has no `pool.rpool.p` /
    `pool.whiten` entry (the regional net), and it looks the edge filter's
    leaf `p` up in its leaf table before its `preprocessing` branch. A
    padded-bucket mask is refused where JAX refuses it."""
    cfg = NETS[name]
    jnet, v, net = _jax_net(cfg)
    x = _img()
    want = np.asarray(jnet.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert net.meta["regional"] is (name == "regional_gem")
    sd = {k: t.numpy() for k, t in net.state_dict().items()}
    key_map = ti.key_map_for_architecture(cfg["architecture"])
    if name in ("regional_gem", "edge_filter"):
        assert {"pool.rpool.p", "pool.whiten.weight"} <= set(sd) \
            if name == "regional_gem" else "preprocessing.tau" in sd
        with pytest.raises(KeyError):
            ti.convert_torch_state(_host(v), sd, key_map=key_map)
    else:
        back = ti.convert_torch_state(_host(v), sd, key_map=key_map,
                                      min_coverage=1.0)
        for k, t in from_jax_variables(_host(back)).items():
            np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)
    if name in ("regional_gem", "rmac", "geometric_median"):
        with pytest.raises(ValueError, match="mask is not supported"):
            net(torch.from_numpy(x), mask=torch.ones(2, HW, HW))


def test_edge_filter_gradients_against_jax():
    """The edge filter's output within 1e-6 and its gradients with respect
    to p and tau within 1e-5 of jax.grad's, on values across the
    sigmoid's knee and the eps clamp."""
    x = np.random.RandomState(3).uniform(-0.05, 0.3, (2, 9, 7, 3)) \
        .astype(np.float32)
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jm = jextra.EdgeFilter()
    v = {"params": {"p": jnp.full((1,), 0.6), "tau": jnp.full((1,), 0.12)}}
    want_y = np.asarray(jm.apply(v, jnp.asarray(x)))
    grads = jax.grad(lambda v: jnp.sum(jm.apply(v, jnp.asarray(x)) * g))(v)
    m = EdgeFilter()
    with torch.no_grad():
        m.p.fill_(0.6)
        m.tau.fill_(0.12)
    y = m(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0, atol=1e-6)
    (y * torch.from_numpy(g)).sum().backward()
    for name in ("p", "tau"):
        np.testing.assert_allclose(
            getattr(m, name).grad.numpy(),
            np.asarray(grads["params"][name]), rtol=1e-5, atol=1e-5)


def test_horde_and_weighted_median_against_jax():
    """HordeCascadedKOrder (order 3, the JAX projections' and embeddings'
    weights carried across) and the weighted geometric median within 1e-5
    of JAX's, its input gradient too (the weights detached in both)."""
    x = np.abs(np.random.RandomState(5).randn(2, 6, 5, 8)).astype(np.float32)
    jm = jextra.HordeCascadedKOrder(dim=8, order=3, high_order_dims=16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    m = HordeCascadedKOrder(8, 3, 16)
    with torch.no_grad():
        for i, conv in enumerate(m.proj):
            k = np.array(v["params"]["proj_%d" % i]["kernel"])
            conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        for i, lin in enumerate(m.embed):
            k = np.array(v["params"]["embed_%d" % i]["kernel"])
            lin.weight.copy_(torch.from_numpy(k.T))
        got = m(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    att = np.random.RandomState(6).rand(2, 6, 5, 1).astype(np.float32)
    want = jextra.weighted_geometric_median_weiszfeld(
        jnp.asarray(x), jnp.asarray(att))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = weighted_geometric_median_weiszfeld(xt, torch.from_numpy(att))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    got.sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(
        jextra.weighted_geometric_median_weiszfeld(v, jnp.asarray(att))))(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6)


# ---- the parameter groups; the multiscale power

LABELS = {
    "cirnet": NETS["regional_gem"],
    "cirnet_inchan": NETS["edge_filter"],
    "cirnet_attention": NETS["attention"],
    "gem_retrieval": {"architecture": "gem_retrieval", "pooling": "gem",
                      "whitening": True},
}


@pytest.mark.parametrize("label", sorted(LABELS))
def test_param_groups_equal_jax(label):
    """Each parameter's lr and weight-decay multipliers equal JAX's
    `param_group_mults` (GeM p x10 without decay, `pool.rpool.p` of the
    regional net included; the edge filter x10)."""
    cfg = LABELS[label]
    jnet = j_model(dict(cfg))
    shapes = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, HW, HW, 3)))
    params = {"params": seeded_variables(dict(shapes), 0)["params"]}
    lr, wd = param_group_mults(label, params["params"])
    names = list(from_jax_variables(_host(params)))
    want = dict(zip(names, zip(
        jax.tree_util.tree_leaves(lr), jax.tree_util.tree_leaves(wd))))
    net = initialize_model(dict(cfg))
    got = {}
    named = dict(net.named_parameters())
    for lr_m, wd_m, ps in param_groups(label, net.named_parameters()):
        for p in ps:
            got[next(k for k, q in named.items() if q is p)] = (lr_m, wd_m)
    assert got == want
    special = {k: m for k, m in got.items() if m != (1.0, 1.0)}
    assert special == {
        "cirnet": {"pool.rpool.p": (10.0, 0.0)},
        "cirnet_inchan": {"pool.p": (10.0, 0.0),
                          "preprocessing.p": (10.0, 1.0),
                          "preprocessing.tau": (10.0, 1.0)},
        "cirnet_attention": {"pool.p": (10.0, 0.0)},
        "gem_retrieval": {"pool.p": (10.0, 0.0)}}[label]


@pytest.mark.parametrize("name", sorted(NETS))
def test_multiscale_power_equals_jax(name):
    """The multiscale aggregation's power of each net as the JAX
    package's rule gives it: the GeM p (2.5 here) for a plain GeM net and
    the attention net, 1 for the regional, R-MAC, geometric-median and
    edge-filter nets (JAX finds that one's p under `net/` only)."""
    jnet, v, net = _jax_net(NETS[name])
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.full(a.shape, 2.5) if p[-1].key == "gem_p" else a, v)
    for p in net.parameters():
        if p.shape == (1,) and float(p.detach()) == 3.0:
            with torch.no_grad():
                p.fill_(2.5)
    assert wrappers.multiscale_msp(NETS[name], net) == \
        jwrappers.multiscale_msp(NETS[name], v)


# ---- a cirnet_inchan fine-tune tuple step


def test_cirnet_inchan_step_against_jax():
    """finetune.yml's tuple step (`build_finetune_step`) with a cirnet_inchan
    embed (the edge filter before GeM-VGG16), float32, on
    tests/test_torch_finetune.py's micro tuples (T = 2 of S = 3 in a 32
    bucket, masked, taken to ImageNet's normalization as the augment
    chain's meanstd does; the chain is held there and left out here):
    the loss within 1e-5 relative, each parameter's gradient within 5e-5
    of its norm (the step tests' limits), the edge filter's p and tau
    among them, in the x10 group. GeM's p takes no gradient in exact
    arithmetic here (each image's valid features are one position at this
    size, where the generalized mean is p's fixed point): it is held below
    1e-6 of the net's gradient on both sides, as
    tests/test_torch_cyclegan.py holds such gradients. The convs' biases
    are seeded too: below
    tau the filter gives values near 1e-20, and with zero biases the first
    convs' ReLU gates would sit on values whose sign is the summation
    order's (with zero biases the first three convs' gradients land 3e-3
    of their norm apart; the later ones 5e-6)."""
    ecfg = {"model": dict(NETS["edge_filter"], whitening=False),
            "runtime": {"wrappers": "", "data": {}}}
    jembed = j_build(ecfg)
    shapes = jax.eval_shape(
        lambda x: jembed.module.init(jax.random.PRNGKey(0), x),
        jnp.zeros((3, 32, 32, 3)))
    variables = {"embed": seeded_variables(dict(shapes), 21)}
    rs = np.random.RandomState(7)

    def fill(path, a):
        key = path[-1].key
        if key in ("gem_p", "p", "tau"):
            return jnp.full(a.shape, {"gem_p": 3.0, "p": 0.5, "tau": 0.1}[key])
        if key == "bias":
            return jnp.asarray(rs.randn(*a.shape) * 0.05, jnp.float32)
        return a
    variables["embed"] = jax.tree_util.tree_map_with_path(
        fill, variables["embed"])
    variables["embed"] = jax.tree_util.tree_map(jnp.asarray,
                                                variables["embed"])
    embed = build_single_net(ecfg)
    embed.module.load_state_dict(
        from_jax_variables(_host(variables["embed"])), strict=True)

    ax, am, labels, pmask = _batch(seed=5)
    # the augment chain's meanstd_post: the generator's 0.5 / 0.5 to
    # ImageNet's normalization, the band kept at 0
    mean, std = np.float32([0.485, 0.456, 0.406]), np.float32([0.229, 0.224,
                                                                0.225])
    ax = ((ax * 0.5 + 0.5 - mean) / std * am[..., None]).astype(np.float32)
    tx = _grab_grads()
    jstep = jax.jit(jsup.build_finetune_step({"embed": jembed}, tx,
                                             margin=0.75))
    jstate, jm = jstep(jsup.make_finetune_state(variables, tx),
                       jnp.asarray(ax), jnp.asarray(am), jnp.asarray(labels),
                       jnp.asarray(pmask))
    opt, _ = initialize_optimizer(dict(ADAM), embed.module.named_parameters(),
                                  "cirnet_inchan")
    assert sorted((g["lr"] / ADAM["lr"], g["weight_decay"] > 0,
                   len(g["params"])) for g in opt.param_groups) == \
        [(1.0, True, 26), (10.0, False, 1), (10.0, True, 2)]
    models = {"embed": embed}
    step = supervised.build_finetune_step(models, opt, _criterion())
    state = supervised.make_finetune_state(models, opt)
    _, m = step(state, *_torch(ax, am, labels, pmask))
    grads = {k: p.grad for k, p in embed.module.named_parameters()}
    np.testing.assert_allclose(float(m["total"]), float(jm["total"]),
                               rtol=1e-5)
    jgrads = from_jax_variables(_host({"params": jstate.opt_state}))
    assert {"preprocessing.p", "preprocessing.tau"} <= set(grads)
    net = np.sqrt(sum(float((t.numpy() ** 2).sum())
                      for t in jgrads.values()))
    for k, g in grads.items():
        want = jgrads[k].numpy()
        if np.linalg.norm(want) < 1e-6 * net:   # 0 in exact arithmetic
            assert np.linalg.norm(g.numpy()) < 1e-6 * net, k
            continue
        assert np.linalg.norm(g.numpy() - want) <= \
            5e-5 * np.linalg.norm(want), k
