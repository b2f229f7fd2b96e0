"""Where a GAN step of the registry's new networks spends the card's time,
on one GPU: cut.yml's CUT step with upstream CUT's blur-pool sampling on
G and D against the same step without it (the shipped `no_antialias`),
and cyclegan.yml's step with pix2pix's unet_256 for both generators.

    python3 scripts/torch_arch_profile.py [--steps 5] [--top 12]

Each step is built from its train section at full width as
`chip_smoke.py::run_architectures` runs it (seeded weights, batch 1 of
256x256, float32, CUT on fixed patch positions), warmed up for 3 steps,
then run `--steps` times: ms a step by host clock around the steps
(ending in a synchronise), the card's busy share (`chip_smoke.
_device_busy_us` over a torch.profiler run of the same steps), and the
`--top` CUDA kernels by total device time with their share of it.
Prints the card's name and power limit first.
"""
import argparse
import functools
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _section(yml, overrides):
    from gandtr_tpu_torch.scenarios.engine import load_yaml_scenario
    cfg = load_yaml_scenario([yml] + list(overrides))
    cfg = cfg["train"]["1_train_augment"]
    cfg = {k: v for k, v in cfg.items() if k in ("network", "learning")}
    cfg["learning"]["checkpoints"]["directory"] = None
    return cfg


def profile_step(name, cfg, steps, top):
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as c
    from gandtr_tpu_torch.scenarios.build import build_gan_experiment
    dev = torch.device("cuda")
    exp = build_gan_experiment(cfg, device=dev)
    rs = np.random.RandomState(3)
    X, Y = (torch.from_numpy(rs.uniform(-1, 1, (1, 256, 256, 3))
                             .astype(np.float32)).to(dev) for _ in range(2))
    state = exp["state"]
    for _ in range(3):
        state, _, _ = exp["step"](state, X, Y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _, _ = exp["step"](state, X, Y)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _, _ = exp["step"](state, X, Y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = c._device_busy_us(prof) / 1e6 / wall
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            totals[e.name()] = totals.get(e.name(), 0) \
                + (e.end_ns() - e.start_ns()) / 1e6
    total = sum(totals.values())
    kernels = [{"kernel": k[:120], "ms_a_step": v / steps,
                "share": v / total}
               for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]
    out = {"ms_a_step": ms, "busy_share": busy,
           "device_ms_a_step": total / steps, "top_kernels": kernels}
    print("%s: %s" % (name, json.dumps(out)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_arch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from gandtr_tpu_torch.device import resolve_device
    from gandtr_tpu_torch.learning import gan_steps
    resolve_device(None)
    print(c.card_line())
    pth = {"hed": None, "rcf": None}
    rs = np.random.RandomState(11)
    orig = gan_steps.GAN_STEPS["cut"]
    for name, extra, strides in (
            ("cut_no_antialias", (), (2, 4, 4, 4)),
            ("cut_blur_pool", c.ARCH_BLUR, c.ARCH_BLUR_TAP_STRIDES)):
        ids = [rs.permutation((256 // s) ** 2)[:256] for s in strides]
        gan_steps.GAN_STEPS["cut"] = functools.partial(orig,
                                                       fixed_patch_ids=ids)
        try:
            profile_step(name, _section(c.FAMILY_YML["cut"],
                                        c.family_overrides("cut", pth)
                                        + list(extra)),
                         args.steps, args.top)
        finally:
            gan_steps.GAN_STEPS["cut"] = orig
        torch.cuda.empty_cache()
    profile_step("cyclegan_unet_256",
                 _section(c.CYCLEGAN_YML, c.cyclegan_overrides()
                          + list(c.ARCH_UNET_OVR)), args.steps, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
