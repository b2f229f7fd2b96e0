"""HED^N-GAN's opt-in knobs in the port against the JAX package's, on the
CPU, on the micro HED^N-GAN of tests/torch_gan_common.py: the E step's
`concat_student`, the `external_targets` / `emit_targets` steps, the
teacher-target cache (learning/teacher_cache.py) and the device
scalecrop (`RandomScaleCrop.crop_only`, `DeviceScalecrop`,
ops/resize.py::dynamic_bilinear_resize_u8). One JAX computation a
feature, never the JAX package's training loops."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu.data import transforms as JT
from gandtr_tpu.learning.teacher_cache import \
    TeacherTargetCachingStep as JCache
from gandtr_tpu.ops import losses as JL
from gandtr_tpu.ops.resize import dynamic_bilinear_resize_u8 as j_resize
from gandtr_tpu.scenarios import build as jbuild
from gandtr_tpu.utils import torch_import as ti
from gandtr_tpu_torch.data import transforms as T
from gandtr_tpu_torch.learning import gan_steps
from gandtr_tpu_torch.learning.teacher_cache import TeacherTargetCachingStep
from gandtr_tpu_torch.ops.resize import dynamic_bilinear_resize_u8
from gandtr_tpu_torch.scenarios.build import build_gan_experiment
from gandtr_tpu_torch.utils import weights as W
from torch_gan_common import micro_config, shape_init, without_data

torch.set_num_threads(1)

DRIFT = 2
WEIGHTS = {"adversarial": 1.0, "edge": 5.0, "hed": 1.0}


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [tuple(torch.from_numpy(rs.uniform(-1, 1, (2, 32, 32, 3))
                                   .astype(np.float32)) for _ in range(2))
            for _ in range(n)]


def _snapshot(exp):
    return ({n: copy.deepcopy(m.module.state_dict())
             for n, m in exp["models"].items()},
            copy.deepcopy(exp["state"].state_dict()))


def _restore(exp, snap):
    for n, sd in snap[0].items():
        exp["models"][n].module.load_state_dict(sd)
    exp["state"].load_state_dict(copy.deepcopy(snap[1]))


def _same(exp, snap):
    """Every net's weights and statistics and every optimizer's state
    equal `snap` bit for bit."""
    for n, sd in snap[0].items():
        got = exp["models"][n].module.state_dict()
        assert all(torch.equal(got[k], v) for k, v in sd.items()), n
    assert str(exp["state"].state_dict()) == str(snap[1])


def _with_e_grads(exp, fn):
    """fn()'s result and the student's gradients at its optimizer step,
    by parameter name."""
    opt = exp["optimizers"]["detector"]
    names = {id(p): k for k, p in
             exp["models"]["detector"].module.named_parameters()}
    seen = {}
    orig = opt.step

    def step(*a, **k):
        for g in opt.param_groups:
            for p in g["params"]:
                seen[names[id(p)]] = p.grad.detach().clone()
        return orig(*a, **k)
    opt.step = step
    try:
        return fn(), seen
    finally:
        del opt.step


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The port's micro experiment after DRIFT separate steps, and the JAX
    build's models and variable shapes."""
    cfg = micro_config(str(tmp_path_factory.mktemp("gan_options")))
    with pytest.MonkeyPatch.context() as mp:
        shape_init(mp)
        jexp = jbuild.build_gan_experiment(without_data(cfg), sample_hw=32)
    exp = build_gan_experiment(without_data(cfg), device="cpu")
    host = jax.tree_util.tree_map(np.asarray, jexp["variables"])
    for name, sd in W.from_jax_variables(host).items():
        exp["models"][name].module.load_state_dict(sd, strict=True)
    init = _snapshot(exp)
    state = exp["state"]
    for X, Y in _batches(DRIFT, seed=1):
        state, _, _ = exp["step"](state, X, Y)
    return {"cfg": cfg, "exp": exp, "jexp": jexp, "init": init,
            "drifted": _snapshot(exp)}


def _step(exp, **knobs):
    m = exp["models"]
    return gan_steps.build_hedngan_step(m, exp["optimizers"], WEIGHTS,
                                        **knobs)


def test_concat_student_after_drift(micro):
    """After the drift, one step with `concat_student` against the same
    step with separate forwards: the E losses within 1e-6 and the
    student's gradient within 1e-5 of its largest entry; and against the JAX
    package's concat E step (the student on the concatenated batch, the
    two L1s, their gradient) on the same weights and inputs."""
    exp = micro["exp"]
    X, Y = _batches(1, seed=2)[0]
    _restore(exp, micro["drifted"])
    (_, m_sep, _), g_sep = _with_e_grads(
        exp, lambda: exp["step"](exp["state"], X, Y))
    _restore(exp, micro["drifted"])
    H_s, H_t = exp["models"]["detector"], exp["models"]["detector_frozen"]
    inputs, apply = [], H_s.apply

    def recording(x, **kw):
        inputs.append(x.detach().clone())
        return apply(x, **kw)
    H_s.apply = recording
    try:
        (_, m_cat, _), g_cat = _with_e_grads(
            exp, lambda: _step(exp, concat_student=True)(exp["state"], X, Y))
    finally:
        del H_s.apply
    assert float(m_sep["E_real"]) > 0     # drifted: no tie left
    for k in ("E_real", "E_fake"):
        np.testing.assert_allclose(float(m_cat[k]), float(m_sep[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    top = max(float(g.abs().max()) for g in g_sep.values())
    for k, g in g_sep.items():
        assert float((g_cat[k] - g).abs().max()) <= 1e-5 * top, k

    # the JAX package's concat E step on the same student, inputs, target
    both = inputs[0]
    assert both.shape[0] == 2 * X.shape[0]
    _restore(exp, micro["drifted"])
    with torch.no_grad():
        target = H_t.apply(X, no_sigmoid=True).numpy()
    jH = micro["jexp"]["models"]["detector"]
    hvar = ti.convert_torch_state(
        micro["jexp"]["variables"]["detector"],
        {k: v.numpy() for k, v in H_s.module.state_dict().items()},
        key_map=ti.key_map_for_architecture("hed_interpolation"),
        min_coverage=1.0)
    n = X.shape[0]

    def e_loss(params, x, tgt):
        out = jH.apply({**hvar, "params": params}, x, train=False,
                       no_sigmoid=True)
        e_real = JL.l1_loss(out[:n], tgt)
        e_fake = JL.l1_loss(out[n:], tgt)
        return e_real + e_fake, (e_real, e_fake)
    (_, (je_real, je_fake)), jg = jax.jit(jax.value_and_grad(
        e_loss, has_aux=True))(hvar["params"], jnp.asarray(both.numpy()),
                               jnp.asarray(target))
    # the maps are O(1) and the student 2e-3 off its teacher: their
    # rounding is absolute
    np.testing.assert_allclose(float(je_real), float(m_cat["E_real"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(je_fake), float(m_cat["E_fake"]),
                               rtol=0, atol=1e-6)
    jg = W.from_jax_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                                jg)})
    for k, g in g_cat.items():
        assert float((jg[k] - g).abs().max()) <= 1e-5 * top, k


def test_separate_forwards_keep_the_tie_at_init(micro):
    """At init the student is its teacher: the separate forwards give an
    exactly zero E_real and an exactly zero real-branch gradient, as the
    JAX package's L1 does at a tie."""
    exp = micro["exp"]
    _restore(exp, micro["init"])
    X, Y = _batches(1, seed=3)[0]
    H_s, H_t = exp["models"]["detector"], exp["models"]["detector_frozen"]
    with torch.no_grad():
        target = H_t.apply(X, no_sigmoid=True)
    real_M = H_s.apply(X, no_sigmoid=True)
    assert torch.equal(real_M.detach(), target)
    grads = torch.autograd.grad(
        torch.abs(real_M - target).mean(), list(H_s.module.parameters()))
    assert all(float(g.abs().max()) == 0.0 for g in grads)
    t = jnp.asarray(target.numpy())
    jg = jax.grad(lambda a: JL.l1_loss(a, t))(t)
    assert float(jnp.abs(jg).max()) == 0.0
    (_, m, _) = exp["step"](exp["state"], X, Y)
    assert float(m["E_real"]) == 0.0


def test_external_targets_equal_the_internal_step(micro):
    """The step that takes target_M equals, bit for bit, the step that
    computes it and hands it out (`emit_targets`)."""
    exp = micro["exp"]
    X, Y = _batches(1, seed=4)[0]
    _restore(exp, micro["drifted"])
    _, m_int, d_int = _step(exp, emit_targets=True)(exp["state"], X, Y)
    after = _snapshot(exp)
    target = d_int.pop("target_M")
    with torch.no_grad():
        want = exp["models"]["detector_frozen"].apply(X, no_sigmoid=True)
    assert torch.equal(target, want)
    _restore(exp, micro["drifted"])
    _, m_ext, d_ext = _step(exp, external_targets=True)(exp["state"], X, Y,
                                                        target)
    _same(exp, after)
    assert all(torch.equal(m_ext[k], m_int[k]) for k in m_int)
    assert sorted(d_ext) == sorted(d_int)
    with pytest.raises(TypeError, match="external_targets"):
        _step(exp)(exp["state"], X, Y, target)


def _stub_pair(calls):
    """A step pair for the cache alone: the internal one emits a target
    made from its batch, the external one records the target it got."""
    def internal(state, X, Y):
        calls.append(("internal", float(np.asarray(X).sum())))
        return state + 1, {}, {"target_M": np.asarray(X) * 2, "x": 0}

    def external(state, X, Y, target):
        calls.append(("external", float(np.asarray(target).sum())))
        return state + 1, {}, {"x": 0}
    return internal, external


def test_cache_accounting_against_jax():
    """Hits, misses, LRU eviction and a content change recomputing, call
    for call against the JAX package's TeacherTargetCachingStep on the
    same batch sequence (max_items 2)."""
    rs = np.random.RandomState(0)
    a, b, c = (rs.rand(2, 4, 4, 3).astype(np.float32) for _ in range(3))
    a2 = a.copy()
    a2[0, 0, 0, 0] += 1e-3
    y = np.zeros_like(a)
    seq = [a, a, b, c, a, b, b, a2, c, a]
    pcalls, jcalls = [], []
    pcache = TeacherTargetCachingStep(*_stub_pair(pcalls), device="cpu",
                                      max_items=2)
    jcache = JCache(*_stub_pair(jcalls), max_items=2)
    pstate = jstate = 0
    for x in seq:
        pargs = pcache.batch_to_args((x, y))
        jargs = jcache.batch_to_args((x, y))
        assert pargs[2] == jargs[2]
        pstate, _, pd = pcache(pstate, *pargs)
        jstate, _, jd = jcache(jstate, *jargs)
        assert "target_M" not in pd and sorted(pd) == sorted(jd)
    assert pcalls == jcalls
    assert (pcache.hits, pcache.misses) == (jcache.hits, jcache.misses) \
        == (2, 8)
    assert list(pcache._cache) == list(jcache._cache)


def test_cached_run_is_the_uncached_run(micro):
    """Two epochs over the same two batches through the build's cache
    (`cache_teacher_targets`) and through the plain step, from the same
    weights: 2 misses, 2 hits, and the two runs equal bit for bit."""
    cfg = copy.deepcopy(micro["cfg"])
    cfg["learning"]["training"]["epoch_iteration"][
        "cache_teacher_targets"] = {"max_items": 4}
    cached = build_gan_experiment(without_data(cfg), device="cpu")
    assert isinstance(cached["step"], TeacherTargetCachingStep)
    exp = micro["exp"]
    _restore(exp, micro["init"])
    _restore(cached, micro["init"])
    batches = [tuple(t.numpy() for t in b) for b in _batches(2, seed=5)]
    state, cstate = exp["state"], cached["state"]
    for _ in range(2):
        for X, Y in batches:
            state, m, _ = exp["step"](state, torch.from_numpy(X),
                                      torch.from_numpy(Y))
            cstate, cm, cd = cached["step"](
                cstate, *cached["step"].batch_to_args((X, Y)))
            assert all(torch.equal(cm[k], m[k]) for k in m)
            assert "target_M" not in cd
    assert (cached["step"].hits, cached["step"].misses) == (2, 2)
    _same(cached, _snapshot(exp))


def _pics(seed):
    rs = np.random.RandomState(seed)
    shapes = [(40, 48), (48, 40), (36, 36), (64, 50)]
    h, w = shapes[seed % len(shapes)]
    return [rs.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)]


@pytest.mark.parametrize("spec", [("32_32", "0.8_1"), ("30_26", "0.85_1"),
                                  ("28_28", "0.9_1")])
def test_crop_only_draws_as_jax(spec):
    """The same seed gives the same crops as the JAX RandomScaleCrop's
    crop_only, image pair after image pair, and DeviceScalecrop the same
    padded uint8 buffers and sizes as the JAX package's."""
    psc, jsc = T.RandomScaleCrop(*spec), JT.RandomScaleCrop(*spec)
    assert psc.max_crop_side == jsc.max_crop_side
    T.seed_transforms(3)
    JT.seed_transforms(3)
    for seed in range(8):
        pics = _pics(seed)
        pcrops, psize = psc.crop_only(*pics)
        jcrops, jsize = jsc.crop_only(*pics)
        assert psize == (jsize if jsize is None else tuple(jsize))
        for p, j in zip(pcrops, jcrops):
            assert np.array_equal(p, j)
    T.seed_transforms(4)
    JT.seed_transforms(4)
    pdsc, jdsc = T.DeviceScalecrop(psc), JT.DeviceScalecrop(jsc)
    for seed in range(8):
        pics = _pics(seed)
        for p, j in zip(pdsc(*pics), jdsc(*pics)):
            assert p.dtype == j.dtype and np.array_equal(p, j)


def test_dynamic_resize_against_jax_and_the_host_chain():
    """Each crop's device resize within 1e-6 of the JAX package's and of
    the host chain's cv2-form resize of the same crop (the loader's
    resize_linear); an unchanged size is the identity."""
    rs = np.random.RandomState(6)
    pad, hws, bufs, crops = 40, [], [], []
    for _ in range(6):
        h, w = int(rs.randint(32, pad + 1)), int(rs.randint(32, pad + 1))
        crop = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
        buf = np.zeros((pad, pad, 3), np.uint8)
        buf[:h, :w] = crop
        hws.append((h, w))
        bufs.append(buf)
        crops.append(crop)
    hws.append((32, 32))
    bufs.append(bufs[0])
    crops.append(crops[0][:32, :32])
    got = dynamic_bilinear_resize_u8(torch.from_numpy(np.stack(bufs)),
                                     torch.tensor(hws), 32, 32).numpy()
    want = np.asarray(j_resize(jnp.asarray(np.stack(bufs)),
                               jnp.asarray(hws, np.int32), 32, 32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for g, crop in zip(got, crops):
        host = T.resize_linear(crop.astype(np.float32) / 255.0, 32, 32)
        np.testing.assert_allclose(g, host, rtol=0, atol=1e-6)
    assert np.array_equal(got[-1], crops[-1].astype(np.float32) / 255.0)


def test_device_scalecrop_batch_is_the_host_batch(micro, tmp_path):
    """The build's loader with `device_scalecrop` ships uint8 crops of the
    boxes the host chain cuts (same seed, same draws); staged on the
    device they are the host chain's normalized images within 1e-5."""
    batches = {}
    for knob in (False, True):
        cfg = copy.deepcopy(micro["cfg"])
        cfg["data"]["train"]["device_scalecrop"] = knob
        exp = build_gan_experiment(cfg, device="cpu")
        T.seed_transforms(0)
        np.random.seed(0)
        exp["loader"].dataset.prepare_epoch()
        batch = next(iter(exp["loader"]))
        batches[knob] = (exp, batch)
    host = batches[False][1]
    exp, dev = batches[True]
    assert isinstance(exp["loader"].dataset.transform, T.DeviceScalecrop)
    assert [a.dtype for a in dev] == [np.uint8, np.int32] * 2
    pad = exp["loader"].dataset.transform.pad
    assert dev[0].shape[1:] == (pad, pad, 3)
    stage = exp["step"].stage
    for u8, hw, want in ((dev[0], dev[1], host[0]), (dev[2], dev[3], host[1])):
        got = stage(torch.from_numpy(u8), torch.from_numpy(hw))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
