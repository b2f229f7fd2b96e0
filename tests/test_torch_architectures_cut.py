"""The CUT step with upstream CUT's blur-pool sampling on G and D against
the JAX package's, on the CPU (split from test_torch_architectures.py,
whose helpers it uses: the JAX CUT build is this file's alone)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandtr_tpu_torch.utils.weights import from_jax_variables
from test_torch_architectures import SIDE, _gan_pair, _host

torch.set_num_threads(1)


def test_cut_step_with_blur_pool_against_jax(tmp_path):
    """cut.yml's train section at test_torch_cut.py's micro size with
    upstream CUT's blur-pool sampling on G (no_antialias and
    no_antialias_up false) and D: two steps through `build_cut_step` on
    fixed patch positions (taps 4, 8, 12, 16 are 32², 16², 8², 16² here),
    each metric within test_torch_cut.py's rtol 2e-3 / atol 2e-4 of JAX's,
    every parameter within 2 lr per Adam step (`adam_reach`)."""
    from gandtr_tpu.learning import gan_steps as jgs
    from gandtr_tpu.scenarios.engine import load_yaml_scenario
    from gandtr_tpu_torch.learning import gan_steps as pgs
    from test_torch_cut import CUT_YML, METRICS, _micro_cut
    from torch_gan_common import adam_reach, micro_section
    section = micro_section(
        load_yaml_scenario([CUT_YML])["train"]["1_train_augment"],
        str(tmp_path))
    _micro_cut(section)
    section["network"]["generator_X"]["model"].update(
        no_antialias=False, no_antialias_up=False)
    section["network"]["discriminator_Y"]["model"]["no_antialias"] = False
    ids = [np.random.RandomState(11).permutation(n)[:min(256, n)]
           for n in (1024, 256, 64, 256)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgs, "build_cut_step", functools.partial(
            jgs.build_cut_step, fixed_patch_ids=ids))
        mp.setitem(pgs.GAN_STEPS, "cut", functools.partial(
            pgs.build_cut_step, fixed_patch_ids=ids))
        jexp, exp = _gan_pair(section, str(tmp_path), mp)
        jstate, state = jexp["state"], exp["state"]
        rs = np.random.RandomState(0)
        for n in (1, 2):
            X, Y = (rs.uniform(-1, 1, (1, SIDE, SIDE, 3)).astype(np.float32)
                    for _ in range(2))
            jstate, jm, _ = jexp["step"](jstate, jnp.asarray(X),
                                         jnp.asarray(Y))
            state, pm, _ = exp["step"](state, torch.from_numpy(X),
                                       torch.from_numpy(Y))
            for k in METRICS:
                np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                           rtol=2e-3, atol=2e-4, err_msg=k)
            jv = from_jax_variables(_host(jstate.variables))
            for name in ("generator_X", "featdown", "discriminator_Y"):
                (group,) = exp["optimizers"][name].param_groups
                bound = 2 * group["lr"] * adam_reach(n, group["betas"][0])
                sd = exp["models"][name].module.state_dict()
                for key, want in jv[name].items():
                    assert float((sd[key] - want).abs().max()) <= bound, \
                        (n, name, key)
    blurs = [type(m).__name__ for m in
             exp["models"]["generator_X"].module.model]
    assert blurs.count("BlurDownsample") == blurs.count("BlurUpsample") == 2
