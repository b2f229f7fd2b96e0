"""The GAN train steps, HED^N-GAN, HED-GAN, CUT and CycleGAN
(counterpart of gandtr_tpu/learning/gan_steps.py). RCF-GAN and RCF^N-GAN
are HED-GAN and HED^N-GAN with RCF detectors (models/rcf.py).

HED^N-GAN (the reference's SupervisedHEDNGANEpoch, edges_epochs.py:
61-121): one step on a batch (real_X day images, real_Y night images), in the
reference's order:

1. one generator forward, fake_Y = G(real_X), whose graph is kept for (4);
2. the D step: D(real_Y) then D(fake_Y.detach()), each in train mode (its
   BatchNorm moves the running statistics, real first), the mse against
   the inverted targets (real -> 0, fake -> 1), averaged; one Adam step;
3. the E step: the frozen teacher's pre-sigmoid map target_M of real_X,
   without autograd; the student's pre-sigmoid maps of real_X and of
   fake_Y.detach(), each L1 against target_M; one Adam step. The student
   starts equal to the teacher, so at the first step real_M == target_M
   bit for bit and the real branch takes no gradient (L1's tie);
4. the G step through the updated D (train mode: a third move of its
   statistics) and the updated student: the mse of D(fake_Y) against the
   "real" target and the L1 of the student's edge map of fake_Y against
   real_E = sigmoid(target_M), backpropagated through the kept graph of
   (1); one Adam step. D and the student take no parameter gradient here.

The step returns (state, metrics, debug): the metrics `total` (G + D
losses), `D_real`, `D_fake`, `G_gan`, `G_hed`, `E_real`, `E_fake` as 0-dim
tensors on the device, and the last sample of the batch's images and edge
maps for the event blobs. Nothing is read back to the host.

`build_hedngan_step`'s opt-in knobs (off by default, as in the JAX
package): `concat_student` runs (3)'s two student forwards as one forward
of the batch [real_X; fake_Y.detach()], split after; `external_targets`
makes the step take target_M as a fourth argument and skip the teacher;
`emit_targets` returns target_M in `debug` (learning/teacher_cache.py
uses the last two). With `concat_student` the student-equals-teacher tie
of the first steps is not guaranteed: a batch of 2N may take other
convolution algorithms, so real_M may differ from target_M by rounding
and the L1 takes a +-1 subgradient where the separate forwards take 0.

`build_hedgan_step`, `build_cut_step` and `build_cyclegan_step` (the
latter with its image pools, learning/image_pool.py) are the other
families' steps (below).
"""
import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from gandtr_tpu_torch.learning.supervised import _to_cpu
from gandtr_tpu_torch.ops import losses as L


@dataclass
class GanState:
    models: Dict[str, Any]       # {name: WrappedNet}
    optimizers: Dict[str, Any]   # {name: torch optimizer}
    pools: Dict[str, Any] = field(default_factory=dict)  # {name: ImagePool}
    step: int = 0
    # {name: CPU torch.Generator}: CUT's patch positions ("patches")
    rngs: Dict[str, Any] = field(default_factory=dict)

    def state_dict(self):
        """What a resume needs besides the networks' weights and
        statistics: every optimizer's state (Adam's moments and step
        counts, on the host), the image pools, the generators' states and
        the step count."""
        return {"optimizers": {name: _to_cpu(opt.state_dict())
                               for name, opt in self.optimizers.items()},
                "pools": {name: pool.state_dict()
                          for name, pool in self.pools.items()},
                "rngs": {name: g.get_state() for name, g in
                         self.rngs.items()},
                "step": int(self.step)}

    def load_state_dict(self, state):
        for name, opt in self.optimizers.items():
            opt.load_state_dict(state["optimizers"][name])
        device = next(next(iter(self.models.values())).module.parameters()
                      ).device
        for name, pool in self.pools.items():
            pool.load_state_dict(state["pools"][name], device)
        for name, g in self.rngs.items():
            g.set_state(state["rngs"][name])
        self.step = int(state["step"])


def make_gan_state(models, optimizers, pools=None, rngs=None):
    return GanState(models=dict(models), optimizers=dict(optimizers),
                    pools=dict(pools or {}), rngs=dict(rngs or {}))


@contextlib.contextmanager
def _no_param_grads(*nets):
    """The nets' parameters take no gradient inside the block."""
    params = [p for net in nets for p in net.module.parameters()
              if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _adversarial(pred, is_real):
    return L.discriminator_loss(pred, is_real, L.mse_loss)[0]


def _d_step(D, opt, real, fake, w_adv):
    """One D update (gan_epochs.py:19-37): D(real) then D(fake), each in
    train mode, the mse against the inverted targets, weighted and
    averaged. Returns (loss, loss_real, loss_fake), detached."""
    opt.zero_grad(set_to_none=True)
    loss_real = w_adv * _adversarial(D.apply(real, train=True), True)
    loss_fake = w_adv * _adversarial(D.apply(fake, train=True), False)
    loss = (loss_real + loss_fake) * 0.5
    loss.backward()
    opt.step()
    return loss.detach(), loss_real.detach(), loss_fake.detach()


def build_hedngan_step(models, optimizers, weights, concat_student=False,
                       external_targets=False, emit_targets=False):
    """step(state, real_X, real_Y) -> (state, metrics, debug) for `models`
    {generator_X, discriminator_Y, detector, detector_frozen} (WrappedNets)
    and an optimizer for each of the first three. `weights` are the
    criterion's {adversarial, edge, hed} (1, 5, 1 as published). With
    `external_targets` the step is step(state, real_X, real_Y, target_M);
    the knobs are the module docstring's."""
    w_adv = float(weights.get("adversarial", 1.0))
    w_edge = float(weights.get("edge", 5.0))
    w_hed = float(weights.get("hed", 1.0))
    G, D = models["generator_X"], models["discriminator_Y"]
    H_s, H_t = models["detector"], models["detector_frozen"]
    opt_g, opt_d = optimizers["generator_X"], optimizers["discriminator_Y"]
    opt_e = optimizers["detector"]

    def step(state, real_X, real_Y, *ext):
        if len(ext) != int(external_targets):
            raise TypeError("the step takes target_M exactly when built "
                            "with external_targets")
        # (1) the one generator forward
        fake_Y = G.apply(real_X, train=True)
        fake_sg = fake_Y.detach()

        # (2) D step
        d_loss, d_real, d_fake = _d_step(D, opt_d, real_Y, fake_sg, w_adv)

        # (3) E step: the student distilled on the frozen teacher
        if external_targets:
            target_M = ext[0].detach()
        else:
            with torch.no_grad():
                target_M = H_t.apply(real_X, train=False, no_sigmoid=True)
        opt_e.zero_grad(set_to_none=True)
        if concat_student:
            both_M = H_s.apply(torch.cat([real_X, fake_sg]), train=False,
                               no_sigmoid=True)
            real_M, fake_M = both_M[:real_X.shape[0]], \
                both_M[real_X.shape[0]:]
        else:
            real_M = H_s.apply(real_X, train=False, no_sigmoid=True)
            fake_M = H_s.apply(fake_sg, train=False, no_sigmoid=True)
        e_real = w_hed * L.l1_loss(real_M, target_M)
        e_fake = w_hed * L.l1_loss(fake_M, target_M)
        (e_real + e_fake).backward()
        opt_e.step()

        # (4) G step through the updated D and student
        real_E = torch.sigmoid(target_M)
        opt_g.zero_grad(set_to_none=True)
        with _no_param_grads(D, H_s):
            g_gan = w_adv * _adversarial(D.apply(fake_Y, train=True), True)
            fake_E = H_s.apply(fake_Y, train=False)
            g_hed = w_edge * L.l1_loss(fake_E, real_E)
            g_loss = g_gan + g_hed
            g_loss.backward()
        opt_g.step()

        with torch.no_grad():
            # the updated student on the last real image: its drift from
            # the teacher, for the blobs
            real_E_check = H_s.apply(real_X[-1:], train=False)[0]
        state.step += 1
        metrics = {"total": g_loss.detach() + d_loss,
                   "D_real": d_real, "D_fake": d_fake,
                   "G_gan": g_gan.detach(), "G_hed": g_hed.detach(),
                   "E_real": e_real.detach(), "E_fake": e_fake.detach()}
        debug = {"real_X": real_X[-1], "real_Y": real_Y[-1],
                 "fake_Y": fake_sg[-1], "real_E": real_E[-1],
                 "fake_E": fake_E.detach()[-1],
                 "real_E_check": real_E_check}
        if emit_targets:
            debug["target_M"] = target_M
        return state, metrics, debug

    return step


def build_hedgan_step(models, optimizers, weights):
    """step(state, real_X, real_Y) -> (state, metrics, debug) for `models`
    {generator_X, discriminator_Y, detector} (WrappedNets; the detector,
    HED or RCF, does not train) and an optimizer for the first two;
    `weights` are the criterion's {adversarial, edge} (1, 5 as
    published). The reference's order (edges_epochs.py:8-54):

    1. one generator forward, fake_Y = G(real_X), kept for (3);
    2. the D step on real_Y and fake_Y.detach(), as HED^N-GAN's;
    3. the G step through the updated D (train mode: its statistics move
       again) and the detector in eval mode: the mse of D(fake_Y) against
       "real" and the L1 of the detector's edge map of fake_Y against
       real_E, its map of real_X without autograd; one Adam step. D and
       the detector take no parameter gradient.

    The metrics are `total`, `D_real`, `D_fake`, `G_gan`, `G_hed`; the
    debug dict the last sample's images and edge maps."""
    w_adv = float(weights.get("adversarial", 1.0))
    w_edge = float(weights.get("edge", 5.0))
    G, D, H = (models[k] for k in ("generator_X", "discriminator_Y",
                                   "detector"))
    opt_g = optimizers["generator_X"]

    def step(state, real_X, real_Y):
        fake_Y = G.apply(real_X, train=True)
        fake_sg = fake_Y.detach()
        d_loss, d_real, d_fake = _d_step(D, optimizers["discriminator_Y"],
                                         real_Y, fake_sg, w_adv)
        with torch.no_grad():
            real_E = H.apply(real_X, train=False)
        opt_g.zero_grad(set_to_none=True)
        with _no_param_grads(D, H):
            g_gan = w_adv * _adversarial(D.apply(fake_Y, train=True), True)
            fake_E = H.apply(fake_Y, train=False)
            g_hed = w_edge * L.l1_loss(fake_E, real_E)
            g_loss = g_gan + g_hed
            g_loss.backward()
        opt_g.step()
        state.step += 1
        metrics = {"total": g_loss.detach() + d_loss, "D_real": d_real,
                   "D_fake": d_fake, "G_gan": g_gan.detach(),
                   "G_hed": g_hed.detach()}
        debug = {"real_X": real_X[-1], "real_Y": real_Y[-1],
                 "fake_Y": fake_sg[-1], "real_E": real_E[-1],
                 "fake_E": fake_E.detach()[-1]}
        return state, metrics, debug

    return step


@contextlib.contextmanager
def _statistics_kept(module):
    """The module's BatchNorm running statistics put back, at the end of
    the block, to what they were at its start: the JAX package discards
    CUT's encoder passes' updates of them."""
    saved = [(b, b.clone()) for name, b in module.named_buffers()
             if name.rsplit(".", 1)[-1] in ("running_mean", "running_var",
                                            "num_batches_tracked")]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def build_cut_step(models, optimizers, weights, nce_layers=(4, 8, 12, 16),
                   num_patches=256, temperature=0.07, nce_weight=1.0,
                   batch_dim_for_bmm=1, fixed_patch_ids=None):
    """step(state, real_X, real_Y) -> (state, metrics, debug) for `models`
    {generator_X, featdown, discriminator_Y} (WrappedNets; featdown a
    PatchSampleF) and an optimizer each; `weights` are the criterion's
    {adversarial, identity} (1, 10 as published), the rest its `nce`
    section. The reference's order (cut_epochs.py:20-89):

    1. one generator forward on [real_X; real_Y] (the identity trick):
       fake_Y and idt_Y, kept for (3);
    2. the D step on real_Y and fake_Y.detach();
    3. the joint G and featdown step: the mse of D(fake_Y) (the updated
       D, train mode) against "real", plus the mean of PatchNCE(real_X ->
       fake_Y) and of the identity PatchNCE(real_Y -> idt_Y); one Adam
       step each. A PatchNCE runs the generator's taps (`nce_layers`,
       train mode, BatchNorm statistics left as they were) on the source
       and on the output, samples `num_patches` positions a tap from the
       source's (the key, no gradient) and the same ones from the
       output's (the query), and takes the multilayer loss.

    As in the reference, the criterion's `weight` multiplies each tap's
    loss inside the multilayer loss and the NCE term again outside it:
    the NCE term scales by weight squared and the identity term by
    identity x weight (the same at the published weight 1).

    Positions come from `state.rngs["patches"]`, a CPU torch.Generator,
    or `fixed_patch_ids` (one index array a tap, both PatchNCEs) when
    given. The metrics are `total`, `D_real`, `D_fake`, `G_gan`, `G_nce`
    (the averaged NCE term), `G_idt`; the debug dict the last sample's
    images and idt_Y."""
    w_adv = float(weights.get("adversarial", 1.0))
    w_idt = float(weights.get("identity", 10.0))
    w_nce = float(nce_weight)
    nce_layers = [int(i) for i in nce_layers]
    G, F, D = (models[k] for k in ("generator_X", "featdown",
                                   "discriminator_Y"))
    opt_g, opt_f = optimizers["generator_X"], optimizers["featdown"]

    def nce(src, dst, generator):
        feat_q = G.apply(dst, train=True, layers=nce_layers,
                         encode_only=True)
        with torch.no_grad():
            feat_k = G.apply(src, train=True, layers=nce_layers,
                             encode_only=True)
            pool_k, ids = F.apply(feat_k, train=True,
                                  num_patches=num_patches,
                                  patch_ids=fixed_patch_ids,
                                  generator=generator)
        pool_q, _ = F.apply(feat_q, train=True, num_patches=num_patches,
                            patch_ids=ids)
        return L.multilayer_patch_nce_loss(pool_q, pool_k, batch_dim_for_bmm,
                                           temperature, w_nce)[0]

    def step(state, real_X, real_Y):
        n = real_X.shape[0]
        fake = G.apply(torch.cat([real_X, real_Y]), train=True)
        fake_Y, idt_Y = fake[:n], fake[n:]
        fake_sg = fake_Y.detach()
        d_loss, d_real, d_fake = _d_step(D, optimizers["discriminator_Y"],
                                         real_Y, fake_sg, w_adv)
        generator = state.rngs.get("patches")
        opt_g.zero_grad(set_to_none=True)
        opt_f.zero_grad(set_to_none=True)
        # the statistics go back after the backward, which needs them as
        # the encoder passes left them
        with _no_param_grads(D), _statistics_kept(G.module):
            g_gan = w_adv * _adversarial(D.apply(fake_Y, train=True), True)
            g_nce = w_nce * nce(real_X, fake_Y, generator)
            if w_idt > 0.0 and w_nce > 0.0:
                g_idt = w_idt * nce(real_Y, idt_Y, generator)
                g_nce_total = (g_nce + g_idt) * 0.5
            else:
                g_idt = torch.zeros((), device=fake.device)
                g_nce_total = g_nce
            g_loss = g_gan + g_nce_total
            g_loss.backward()
        opt_g.step()
        opt_f.step()
        state.step += 1
        metrics = {"total": g_loss.detach() + d_loss, "D_real": d_real,
                   "D_fake": d_fake, "G_gan": g_gan.detach(),
                   "G_nce": g_nce_total.detach(), "G_idt": g_idt.detach()}
        debug = {"real_X": real_X[-1], "real_Y": real_Y[-1],
                 "fake_Y": fake_sg[-1], "idt_Y": idt_Y.detach()[-1]}
        return state, metrics, debug

    return step


def build_cyclegan_step(models, optimizers, weights_GX, weights_GY):
    """step(state, real_X, real_Y) -> (state, metrics, debug) for `models`
    {generator_X, generator_Y, discriminator_X, discriminator_Y}
    (WrappedNets, D_X judging domain Y) and an optimizer each; the
    weights are each generator loss's {adversarial, cycle} (1, 10 as
    published). The reference's order (gan_epochs.py:61-140):

    1. the joint generator step through one graph: fake_Y = G_X(real_X),
       rec_X = G_Y(fake_Y), fake_X = G_Y(real_Y), rec_Y = G_X(fake_X),
       each in train mode (a BatchNorm's statistics move call by call, as
       the JAX step threads them), then D_X(fake_Y) and D_Y(fake_X)
       against "real" (D's statistics move too, its parameters take no
       gradient); the mse terms and the L1 cycle terms, weighted; one
       backward of both losses, one Adam step each;
    2. each D step on its pool's answer to the (detached) fakes of (1):
       D(real) then D(pool(fake)), each mse against its target, averaged;
       one Adam step each, D_X first.

    The metrics are the weighted partials under the reference's key forms
    (`netG_X_adversarial`, `netG_X_cycle`, ..., `netD_X_total`) and
    `total`."""
    w_adv_x = float(weights_GX.get("adversarial", 1.0))
    w_cyc_x = float(weights_GX.get("cycle", 10.0))
    w_adv_y = float(weights_GY.get("adversarial", 1.0))
    w_cyc_y = float(weights_GY.get("cycle", 10.0))
    GX, GY = models["generator_X"], models["generator_Y"]
    DX, DY = models["discriminator_X"], models["discriminator_Y"]

    def step(state, real_X, real_Y):
        # (1) the joint generator step
        for name in ("generator_X", "generator_Y"):
            optimizers[name].zero_grad(set_to_none=True)
        fake_Y = GX.apply(real_X, train=True)
        rec_X = GY.apply(fake_Y, train=True)
        fake_X = GY.apply(real_Y, train=True)
        rec_Y = GX.apply(fake_X, train=True)
        with _no_param_grads(DX, DY):
            adv_X = w_adv_x * _adversarial(DX.apply(fake_Y, train=True), True)
            adv_Y = w_adv_y * _adversarial(DY.apply(fake_X, train=True), True)
            cyc_X = w_cyc_x * L.l1_loss(rec_X, real_X)
            cyc_Y = w_cyc_y * L.l1_loss(rec_Y, real_Y)
            loss_GX = adv_X + cyc_X
            loss_GY = adv_Y + cyc_Y
            g_total = loss_GX + loss_GY
            g_total.backward()
        optimizers["generator_X"].step()
        optimizers["generator_Y"].step()

        # (2) the D steps on the pools' answers
        fake_Y, fake_X = fake_Y.detach(), fake_X.detach()
        with torch.no_grad():
            fake_Y_pool = state.pools["fake_X_pool"].query(fake_Y)
            fake_X_pool = state.pools["fake_Y_pool"].query(fake_X)
        dx_loss = _d_step(DX, optimizers["discriminator_X"], real_Y,
                          fake_Y_pool, 1.0)[0]
        dy_loss = _d_step(DY, optimizers["discriminator_Y"], real_X,
                          fake_X_pool, 1.0)[0]

        state.step += 1
        metrics = {"total": g_total.detach() + dx_loss + dy_loss,
                   "netG_X_total": loss_GX.detach(),
                   "netG_Y_total": loss_GY.detach(),
                   "netG_X_adversarial": adv_X.detach(),
                   "netG_X_cycle": cyc_X.detach(),
                   "netG_Y_adversarial": adv_Y.detach(),
                   "netG_Y_cycle": cyc_Y.detach(),
                   "netD_X_total": dx_loss, "netD_Y_total": dy_loss}
        debug = {"real_X": real_X[-1], "fake_Y": fake_Y[-1],
                 "rec_X": rec_X.detach()[-1], "real_Y": real_Y[-1],
                 "fake_X": fake_X[-1], "rec_Y": rec_Y.detach()[-1]}
        return state, metrics, debug

    return step


def refused_multihead_step(names):
    """The step of a GAN build with multi-head members `names`: it raises.
    The JAX GAN steps cannot run such a member (their `_apply` calls
    `has_batch_stats`, a WrappedNet method the multi-head container
    lacks), so there is no step to hold a port step against."""
    def step(state, *batch):
        raise NotImplementedError(
            "GAN steps do not run multi-head members (%s): the JAX package's "
            "steps call has_batch_stats, which its MultiheadModule lacks, so "
            "it has no such step to hold one against" % ", ".join(names))
    return step


GAN_STEPS = {
    "hedngan": build_hedngan_step,
    "hedgan": build_hedgan_step,
    "cut": build_cut_step,
    "cyclegan": build_cyclegan_step,
}
