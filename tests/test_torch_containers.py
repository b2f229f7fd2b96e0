"""The port's model containers and compound criteria against the JAX
package's on the CPU (gandtr_tpu_torch/learning/{network,criteria,
optimizers}.py, scenarios/build.py, utils/weights.py):

- `GlobalLocalModule.forward_global` and `forward_local` (five scales) on
  carried weights, 1e-5;
- `MultiheadModule`'s three output modes (a head by default, `head=`, the
  dict of every output) with and without a split, on an encoder and two
  decoders whose JAX variables the port takes through
  `from_jax_variables` (1e-5); the split refusal and JAX's batch-axis
  split (a reference fault);
- `build_network_set` with `MultiheadNetwork` and `SingleNetworkLink`
  members against `build_model_set`: the link is its target's network in
  the port and takes variables of its own in JAX (a port choice);
- the per-subnet optimizer groups against `multihead_group_mults`, in the
  GAN build too; the multi-head `initialize:` spec; a checkpoint round
  trip; the GAN step's refusal;
- `MultiheadLoss` and `CombinationLoss` with scalar and dict weights,
  `normalize_weights`, partials and reduction (1e-6), and a shipped GAN
  config's criterion building and training as before.

The JAX nets take seeded values over their shapes (`jax.eval_shape`), as
tests/torch_gan_common.py does: a real JAX init compiles op by op.
"""
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from gandtr_tpu.learning import criteria as JC
from gandtr_tpu.learning import network as JN
from gandtr_tpu.learning.optimizers import multihead_group_mults
from gandtr_tpu_torch.learning import criteria as PC
from gandtr_tpu_torch.learning import network as PN
from gandtr_tpu_torch.learning.checkpoints import Checkpoints
from gandtr_tpu_torch.learning.optimizers import initialize_optimizer
from gandtr_tpu_torch.models import initialize_model
from gandtr_tpu_torch.utils.weights import from_jax_variables
from torch_gan_common import micro_config, seeded_variables

torch.set_num_threads(1)
TOL = 1e-5


def close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert float(np.abs(got - want).max()) <= tol * max(
        1.0, float(np.abs(want).max()))


def image(seed=0, n=2, h=24, w=28):
    return np.random.RandomState(seed).uniform(-1, 1, (n, h, w, 3)).astype(
        np.float32)


def shape_init(module_init, x, seed):
    """JAX variables by shape, filled by seeded_variables."""
    shapes = jax.eval_shape(lambda v: module_init(jax.random.PRNGKey(0), v),
                            jnp.asarray(x))
    return jax.tree_util.tree_map(jnp.asarray,
                                  seeded_variables(dict(shapes), seed))


# ---- GlobalLocalModule

class JFeatures(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.relu(fnn.Conv(6, (3, 3), padding="SAME", name="conv")(x))


class TFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 6, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3,
                                                                    1)


def carry_conv(conv, params):
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(np.asarray(params["kernel"]))
                          .permute(3, 2, 0, 1))
        conv.bias.copy_(torch.tensor(np.asarray(params["bias"])))


def test_global_local_forwards_against_jax():
    x = image(h=40, w=52)
    jgl = JN.GlobalLocalModule(JN.WrappedNet(module=JFeatures()))
    var = shape_init(jgl.init, x, 1)
    tf = TFeatures()
    carry_conv(tf.conv, var["params"]["conv"])
    tgl = PN.GlobalLocalModule(PN.WrappedNet(module=tf))
    assert tgl.scales == jgl.scales == (1.0, 0.7071, 0.5, 0.3536, 0.25)
    with torch.no_grad():
        close(tgl.forward_global(torch.tensor(x)),
              jax.jit(jgl.forward_global)(var, jnp.asarray(x)))
        got = tgl.forward_local(torch.tensor(x))
    want = jax.jit(jgl.forward_local)(var, jnp.asarray(x))
    assert len(got) == len(want) == 5
    for (tf_, ta), (jf, ja) in zip(got, want):
        assert ta.shape[-1] == 1
        close(tf_, jf)
        close(ta, ja)
    assert [f.shape[1:3] for f, _ in got] == [
        (40, 52), (28, 36), (20, 26), (14, 18), (10, 13)]


# ---- MultiheadModule

ENC = {"architecture": "official_resnet_encoder", "ngf": 4, "n_blocks": 1}
DEC = {"architecture": "official_resnet_decoder", "ngf": 4, "n_blocks": 1}


def _sub(model, **runtime):
    return {"model": dict(model), "runtime": {"wrappers": "", "data": {},
                                              **runtime}}


def _pair(default_output):
    """The same encoder -> two decoders in both packages, the port's
    weights from the JAX variables through from_jax_variables."""
    from gandtr_tpu.learning.network import build_single_net as jbuild
    jmh = JN.MultiheadModule(jbuild(_sub(ENC)), {
        "a": jbuild(_sub(DEC)), "b": jbuild(_sub(DEC))},
        default_output=default_output)
    x = image()
    var = shape_init(jmh.init, x, 2)
    tmh = PN.MultiheadModule(PN.build_single_net(_sub(ENC)), {
        "a": PN.build_single_net(_sub(DEC)),
        "b": PN.build_single_net(_sub(DEC))}, default_output=default_output)
    tmh.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, var)), strict=True)
    return jmh, var, tmh.eval(), x


def test_multihead_output_modes_without_split():
    jmh, var, tmh, x = _pair("a")
    assert sorted(k.split(".")[0] for k in tmh.state_dict()) == sorted(
        ["base"] * len(list(tmh.base.state_dict()))
        + ["a"] * len(list(tmh.a.state_dict()))
        + ["b"] * len(list(tmh.b.state_dict())))
    tx, jx = torch.tensor(x), jnp.asarray(x)
    with torch.no_grad():
        close(tmh(tx), jmh.apply(var, jx))                 # default "a"
        close(tmh(tx, head="b"), jmh.apply(var, jx, head="b"))
        close(tmh(tx, head="base"), jmh.apply(var, jx, head="base"))
        tmh.default_output = None
        jmh.default_output = None
        got, want = tmh(tx), jmh.apply(var, jx)
    assert sorted(got) == sorted(want) == ["a", "b", "base"]
    for k in want:
        close(got[k], want[k])
    close(got["a"], jmh.apply(var, jx, head="a"))


class JHalves(fnn.Module):
    """A split: the channels' halves, one piece a head."""
    @fnn.compact
    def __call__(self, x):
        c = x.shape[-1] // 2
        return (x[..., :c], x[..., c:])


class THalves(nn.Module):
    def forward(self, x):
        c = x.shape[-1] // 2
        return (x[..., :c], x[..., c:])


class JHead(fnn.Module):
    feats: int

    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(self.feats, (1, 1), name="conv")(x)


class THead(nn.Module):
    def __init__(self, cin, feats):
        super().__init__()
        self.conv = nn.Conv2d(cin, feats, 1)

    def forward(self, x):
        return self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def test_multihead_with_a_split():
    W = JN.WrappedNet
    jmh = JN.MultiheadModule(W(module=JFeatures()), {
        "p": W(module=JHead(2)), "q": W(module=JHead(5))},
        default_output="q", split=W(module=JHalves()))
    x = image(3)
    var = shape_init(jmh.init, x, 3)
    assert set(var) == {"base", "split", "p", "q"}
    tb, tp, tq = TFeatures(), THead(3, 2), THead(3, 5)
    carry_conv(tb.conv, var["base"]["params"]["conv"])
    carry_conv(tp.conv, var["p"]["params"]["conv"])
    carry_conv(tq.conv, var["q"]["params"]["conv"])
    P = PN.WrappedNet
    tmh = PN.MultiheadModule(P(module=tb), {"p": P(module=tp),
                                            "q": P(module=tq)},
                             default_output="q", split=P(module=THalves()))
    tx, jx = torch.tensor(x), jnp.asarray(x)
    with torch.no_grad():
        close(tmh(tx), jmh.apply(var, jx))
        close(tmh(tx, head="p"), jmh.apply(var, jx, head="p"))
        tmh.default_output = jmh.default_output = None
        got, want = tmh(tx), jmh.apply(var, jx)
    assert sorted(got) == sorted(want) == ["base", "p", "q"]
    for k in want:
        close(got[k], want[k])


def test_split_refusal_and_jax_batch_axis_split():
    """A split that returns one tensor: the port refuses; JAX zips it with
    the heads, so with a batch of two each head takes one image (ROADMAP,
    faults of the reference)."""
    W = JN.WrappedNet
    jmh = JN.MultiheadModule(W(module=JFeatures()), {
        "p": W(module=JHead(2)), "q": W(module=JHead(2))},
        default_output="p", split=JN.build_single_net(
            _sub({"architecture": "identity"})))
    x = image(4, n=2)
    var = shape_init(jmh.init, x, 4)
    out = jmh.apply(var, jnp.asarray(x))
    assert out.shape == (24, 28, 2)         # one image, its batch axis gone
    P = PN.WrappedNet
    tmh = PN.MultiheadModule(P(module=TFeatures()), {
        "p": P(module=THead(6, 2)), "q": P(module=THead(6, 2))},
        default_output="p",
        split=PN.build_single_net(_sub({"architecture": "identity"})))
    with pytest.raises(ValueError, match="one piece per head"):
        tmh(torch.tensor(x))
    assert tmh(torch.tensor(x), head="base").shape == (2, 24, 28, 6)
    with pytest.raises(ValueError, match="default_output"):
        PN.MultiheadModule(P(module=TFeatures()), {"p": P(module=TFeatures())},
                           default_output="split")


MH_CFG = {
    "type": "MultiheadNetwork",
    "network_order": "trunk,splitter,desc,cls",
    "runtime": {"default_output": "desc", "data": {"mean_std": [[0.5] * 3,
                                                                 [0.5] * 3]}},
    "parameter_groups": {"trunk": {"lr": 0.1},
                         "cls": {"lr": 10.0, "weight_decay": 0.0},
                         "splitter": {"weight_decay": 3.0}},
    "trunk": _sub(ENC), "splitter": _sub({"architecture": "identity"}),
    "desc": _sub(DEC), "cls": _sub(DEC)}


def test_build_network_set_multihead_and_link():
    setcfg = {"type": "NetworkSet", "gen": _sub(ENC),
              "mh": copy.deepcopy(MH_CFG),
              "alias": {"type": "SingleNetworkLink", "link": "gen"},
              "gone": None}
    tnets, tspecs = PN.build_network_set(copy.deepcopy(setcfg))
    jms, jspecs = JN.build_model_set(copy.deepcopy(setcfg))
    assert list(tnets) == list(jms.nets) == ["gen", "mh", "alias"]
    assert tspecs == jspecs == {}
    mh, jmh = tnets["mh"].module, jms["mh"]
    assert isinstance(mh, PN.MultiheadModule)
    assert mh.default_output == jmh.default_output == "desc"
    assert mh.parameter_groups == jmh.parameter_groups == {
        "base": {"lr": 0.1}, "cls": {"lr": 10.0, "weight_decay": 0.0},
        "split": {"weight_decay": 3.0}}
    assert tnets["mh"].data_params == jmh.data_params == MH_CFG["runtime"][
        "data"]
    assert mh.head_names == tuple(jmh.heads) == ("desc", "cls")
    assert {k.split(".")[0] for k in mh.state_dict()} == {"base", "desc",
                                                          "cls"}
    # the link: the target's network itself in the port (shared weights,
    # as the reference's link); JAX's init_all gives it variables of its
    # own (ROADMAP, the port's choices)
    assert tnets["alias"] is tnets["gen"]
    assert jms["alias"] is jms["gen"]
    x = jnp.asarray(image(5))
    init = jax.jit(jms["alias"].init)
    jvar = {name: init(jax.random.fold_in(jax.random.PRNGKey(0), i), x)
            for i, name in enumerate(jms.nets) if name != "mh"}
    assert not np.allclose(jvar["gen"]["params"]["model_1"]["conv"]["kernel"],
                           jvar["alias"]["params"]["model_1"]["conv"][
                               "kernel"])
    with pytest.raises(KeyError, match="no member"):
        PN.build_network_set({"a": {"type": "SingleNetworkLink",
                                    "link": "b"}})
    with pytest.raises(NotImplementedError, match="Unknown"):
        PN.build_network_set({"a": {"type": "Unknown"}})


def test_parameter_groups_against_multihead_group_mults():
    wrapped = PN.build_multihead_net(copy.deepcopy(MH_CFG))
    jmh = JN.build_multihead_net(copy.deepcopy(MH_CFG))
    # the identity split would cut the batch axis in JAX (the split test):
    # its variables come from the same net without it (it has none)
    jmh.split = None
    var = shape_init(jmh.init, image(6), 6)
    lr_t, wd_t = multihead_group_mults(jmh.parameter_groups, var)
    want = {}
    for name in var:
        lr = set(jax.tree_util.tree_leaves(lr_t[name]))
        wd = set(jax.tree_util.tree_leaves(wd_t[name]))
        if lr:
            want[name] = (lr.pop(), wd.pop())
    opt, _ = initialize_optimizer(
        {"algorithm": "adam", "lr": 2e-4, "weight_decay": 0.5},
        wrapped.module.named_parameters(), "",
        wrapped.module.parameter_groups)
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    seen = set()
    for name, p in wrapped.module.named_parameters():
        sub = name.split(".", 1)[0]
        lr_mult, wd_mult = want[sub]
        g = group_of[id(p)]
        assert g["lr"] == pytest.approx(2e-4 * lr_mult, rel=1e-12)
        assert g["weight_decay"] == pytest.approx(0.5 * wd_mult, rel=1e-12)
        assert g["lr_mult"] == lr_mult
        seen.add(sub)
    assert seen == {"base", "desc", "cls"} and want["desc"] == (1.0, 1.0)
    assert want["base"] == (0.1, 1.0) and want["cls"] == (10.0, 0.0)


def test_multihead_initialize_spec_draws_each_subnet(monkeypatch):
    """`initialize: {weights, seed}` on a multi-head member: each subnet
    drawn from the seed in turn, as JAX's init_all (where seed fixes the
    key), so two subnets of one shape get the same draw in both
    packages."""
    from gandtr_tpu_torch.models.init import initialize_weights
    from gandtr_tpu_torch.scenarios.build import _init_nets
    cfg = copy.deepcopy(MH_CFG)
    spec = {"weights": "kaiming_p2p", "seed": 3, "init_gain": 0.5}
    setcfg = {"type": "NetworkSet", "mh": dict(cfg, initialize=spec)}
    nets, specs = PN.build_network_set(copy.deepcopy(setcfg))
    assert specs == {"mh": spec}
    _init_nets(nets, specs, setcfg, 0, "cpu", {})
    mh = nets["mh"].module
    for name in ("base", "desc", "cls"):
        fresh = initialize_model(dict(MH_CFG[{"base": "trunk"}.get(
            name, name)]["model"]))
        initialize_weights(fresh, "kaiming_p2p", 3, init_gain=0.5)
        for a, b in zip(fresh.state_dict().values(),
                        getattr(mh, name).state_dict().values()):
            assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(
        mh.desc.state_dict().values(), mh.cls.state_dict().values()))
    jms, jspecs = JN.build_model_set(copy.deepcopy(setcfg))
    jms["mh"].split = None     # as in the test above
    jinit = jms["mh"].init
    jms["mh"].init = lambda rng, x: jax.tree_util.tree_map(
        jnp.asarray, seeded_variables(dict(jax.eval_shape(jinit, rng, x)),
                                      7))
    monkeypatch.setattr(JN, "initialize_weights", jax.jit(
        JN.initialize_weights,
        static_argnames=("weights", "seed", "init_gain")))
    jvar = jms.init_all(jax.random.PRNGKey(0), {"mh": jnp.asarray(image(7))},
                        jspecs)["mh"]
    for a, b in zip(jax.tree_util.tree_leaves(jvar["desc"]),
                    jax.tree_util.tree_leaves(jvar["cls"])):
        assert np.array_equal(a, b)


def test_from_jax_variables_multihead_and_codebook():
    _, var, tmh, _ = _pair(None)
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, var))
    assert set(state) == set(tmh.state_dict())
    for k, v in tmh.state_dict().items():
        assert torch.equal(v, state[k])
    from gandtr_tpu_torch.models.grouping import Codebook
    cb = np.random.RandomState(8).randn(16, 4).astype(np.float32)
    book = Codebook(np.zeros((16, 4), np.float32), "res", "top", "uniform",
                    "l2norm", "maxass")
    book.load_state_dict(from_jax_variables(jnp.asarray(cb)), strict=True)
    assert np.array_equal(book.codebook.detach().numpy(), cb)


def test_multihead_checkpoint_round_trip(tmp_path):
    wrapped = PN.build_multihead_net(copy.deepcopy(MH_CFG))
    torch.manual_seed(9)
    for p in wrapped.module.parameters():
        torch.nn.init.normal_(p)
    ck = Checkpoints(str(tmp_path))
    ck.save_epoch(1, {"mh": {"network_params": {"runtime": {}},
                             "model_state": wrapped.module.state_dict()}},
                  train_state={"epoch": 1}, is_last=True)
    fresh = PN.build_multihead_net(copy.deepcopy(MH_CFG))
    fresh.module.load_state_dict(ck.load_net("mh", "_last")["model_state"],
                                 strict=True)
    for k, v in wrapped.module.state_dict().items():
        assert torch.equal(fresh.module.state_dict()[k], v)
    x = torch.tensor(image(9))
    with torch.no_grad():
        assert torch.equal(fresh.apply(x, head="base"),
                           wrapped.apply(x, head="base"))


def _multihead_gan(root):
    cfg = micro_config(str(root))
    gx = cfg["network"]["generator_X"]
    mh = copy.deepcopy(MH_CFG)
    mh["runtime"]["data"] = gx["runtime"]["data"]
    mh["initialize"] = {"weights": "kaiming_p2p", "seed": 0}
    cfg["network"]["generator_X"] = mh
    cfg["learning"]["training"]["optimizer"]["generator_X"][
        "weight_decay"] = 0.25
    return cfg


def test_gan_build_with_a_multihead_member(tmp_path):
    """The GAN build takes the member, its spec and its groups; the step
    refuses it."""
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    cfg = _multihead_gan(tmp_path)
    exp = build_gan_experiment(copy.deepcopy(cfg), device="cpu")
    opt = exp["optimizers"]["generator_X"]
    lr = cfg["learning"]["training"]["optimizer"]["generator_X"]["lr"]
    mults = {"base": (0.1, 1.0), "cls": (10.0, 0.0), "desc": (1.0, 1.0)}
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    for name, p in exp["models"]["generator_X"].module.named_parameters():
        lr_m, wd_m = mults[name.split(".", 1)[0]]
        g = group_of[id(p)]
        assert g["lr"] == pytest.approx(lr * lr_m, rel=1e-12)
        assert g["weight_decay"] == pytest.approx(0.25 * wd_m, rel=1e-12)
    batch = torch.zeros(2, 32, 32, 3)
    with pytest.raises(NotImplementedError, match="has_batch_stats"):
        exp["step"](exp["state"], batch, batch)


# ---- compound criteria

def _loss_inputs(seed=10):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(3, 4).astype(np.float32),
                rs.randn(3, 4).astype(np.float32)) for k in ("a", "b", "c")}


@pytest.mark.parametrize("weights,normalize", [
    (2, False), (2, True), ({"a": 1.0, "b": 5.0, "c": 0.5}, False),
    ({"a": 1.0, "b": 5.0, "c": 0.5}, True)])
@pytest.mark.parametrize("kind", ["multihead_loss", "combination_loss"])
def test_compound_criteria_against_jax(kind, weights, normalize):
    cfg = {"loss": kind, "weights": weights, "normalize_weights": normalize,
           "a": {"loss": "l1"}, "b": {"loss": "mse"},
           "c": {"loss": "mse", "reduction": "sum"}}
    t, j = PC.initialize_criterion(dict(cfg)), JC.initialize_criterion(
        dict(cfg))
    assert t.weights == pytest.approx(j.weights) and t.reduction == \
        j.reduction == "mixed"
    data = _loss_inputs()
    if kind == "multihead_loss":
        args = ({k: torch.tensor(v[0]) for k, v in data.items()},
                {k: torch.tensor(v[1]) for k, v in data.items()})
        jargs = ({k: jnp.asarray(v[0]) for k, v in data.items()},
                 {k: jnp.asarray(v[1]) for k, v in data.items()})
    else:
        args = tuple(torch.tensor(a) for a in data["a"])
        jargs = tuple(jnp.asarray(a) for a in data["a"])
    got, want = t(*args), j(*jargs)
    assert sorted(got.partial) == sorted(want.partial) == ["a", "b", "c"]
    close(got.total, want.total, 1e-6)
    for k in want.partial:
        close(got.partial[k], want.partial[k], 1e-6)


def test_compound_criteria_refusals_and_reduction():
    same = PC.initialize_criterion({"loss": "multihead_loss", "weights": 1,
                                    "x": {"loss": "l1"},
                                    "y": {"loss": "mse"}})
    assert same.reduction == "mean"
    with pytest.raises(ValueError, match="weight keys"):
        PC.initialize_criterion({"loss": "combination_loss",
                                 "weights": {"x": 1.0}, "x": {"loss": "l1"},
                                 "y": {"loss": "l1"}})
    # a member the GAN steps compute still raises by name
    with pytest.raises(NotImplementedError, match="discriminator_loss"):
        PC.initialize_criterion({"loss": "multihead_loss", "weights": 1,
                                 "adv": {"loss": "discriminator_loss"}})


def test_shipped_gan_criterion_builds_and_trains(tmp_path):
    """train_hedngan.yml's criterion (a multihead_loss with a
    discriminator_loss member) passes the family check, and one step of
    the micro build trains every optimized network, as before."""
    from gandtr_tpu_torch.learning.criteria import check_criterion_losses
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    cfg = micro_config(str(tmp_path))
    crit = cfg["learning"]["training"]["criterion"]
    assert crit["loss"] == "multihead_loss"
    check_criterion_losses(crit, "hedngan")
    exp = build_gan_experiment(copy.deepcopy(cfg), device="cpu")
    before = {n: [p.detach().clone() for p in
                  exp["models"][n].module.parameters()]
              for n in ("generator_X", "discriminator_Y", "detector")}
    x = torch.tensor(image(11, n=2, h=32, w=32))
    _, metrics, _ = exp["step"](exp["state"], x, x.flip(1))
    assert np.isfinite(float(metrics["total"]))
    for n, ps in before.items():
        assert any(not torch.equal(a, b) for a, b in zip(
            ps, exp["models"][n].module.parameters())), n
