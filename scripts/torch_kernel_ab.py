"""Compare the port's conv kernels, K2 (vggconv.cu) and K3 (resblock.cu), of
this checkout with those of another source tree, on one GPU.

    python3 scripts/torch_kernel_ab.py OTHER_CSRC [--rounds 6]

OTHER_CSRC is the `gandtr_tpu_torch/csrc` directory of another tree, e.g.
of a parent commit unpacked with `git archive` into a directory that
.gitignore lists. Each kernel present in both trees is built from each (the
port's nvcc flags, into gandtr_tpu_torch/_build/ab/) and called through
that tree's own wrapper (`gandtr_tpu_torch/kernels/<name>.py` beside
OTHER_CSRC), so the two trees may differ in their C interfaces. On the same
seeded inputs (K2 at the fine-tune's two shapes, bf16 out with ReLU; K3 at
the served block shape) each tree must be bit-equal on repeat, and the two
trees must agree within the kernels' limits against their plain versions (a
redesign sums in another order): K2 within 2e-2 of 1 + |y| (bf16 out), K3
within max 0.06 / mean 0.01. Then both are timed alternately: `--rounds`
CUDA-event medians of 10 calls each, the other tree first in even rounds.
Prints the card's name and power limit, ptxas's spill report of each build
and the median of each tree's medians; exits 1 past a limit or on a repeat
that differs.
"""
import argparse
import importlib.util
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gandtr_tpu_torch.kernels import _build  # noqa: E402

NAMES = ("vggconv", "resblock")
K2_TOL = 2e-2                 # bf16 out, of 1 + |y|
K3_MAX, K3_MEAN = chip_smoke.K3_MAX, chip_smoke.K3_MEAN


def _wrapper(csrc, tag, name):
    """`name`'s wrapper module of the tree whose sources are `csrc`, its
    library built from them, and ptxas's spill lines."""
    path = pathlib.Path(csrc).resolve().parent / "kernels" / ("%s.py" % name)
    spec = importlib.util.spec_from_file_location("ab_%s_%s" % (tag, name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC = pathlib.Path(csrc).resolve()
    _build.BUILD_DIR = ROOT / "gandtr_tpu_torch" / "_build" / "ab" / tag
    try:
        mod._lib()
        log = _build.library_path(name)
        log = log.with_name(log.name + ".log")
        spills = ([line.strip() for line in log.read_text().splitlines()
                   if "spill" in line] if log.exists() else [])
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    return mod, spills


def _cases(dev):
    """(kernel name, label, inputs, call(module, inputs), compare)."""
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    def k2_compare(a, b):
        d = (a.float() - b.float()).abs()
        excess = float((d - K2_TOL * (1 + b.float().abs())).max())
        return excess <= 0, "max |diff| %.3g" % float(d.max())

    def k3_compare(a, b):
        d = (a.float() - b.float()).abs()
        mx, mean = float(d.max()), float(d.mean())
        return (mx < K3_MAX and mean < K3_MEAN,
                "max / mean |diff| %.4g / %.3g" % (mx, mean))

    cases = []
    for shape in chip_smoke.K2_SHAPES[:2]:
        C = shape[-1]
        args = (randn(*shape, scale=1.0), randn(9 * C, C, scale=0.05),
                torch.randn(C, generator=g, device=dev))
        cases.append(("vggconv", "K2 %s" % (shape,), args,
                      lambda m, a: m.conv3x3_same_cuda(*a, relu=True),
                      k2_compare))
    N, H, W, C = chip_smoke.K3_SHAPES[0]
    args = (randn(N, H, W, C, scale=0.5), randn(9 * C, C, scale=0.05),
            randn(C, scale=0.1), randn(9 * C, C, scale=0.05),
            randn(C, scale=0.1))
    cases.append(("resblock", "K3 %s" % ((N, H, W, C),), args,
                  lambda m, a: m.fused_resblock_cuda(*a), k3_compare))
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's gandtr_tpu_torch/csrc")
    ap.add_argument("--rounds", type=int, default=6)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    other = pathlib.Path(opts.other)
    names = [n for n in NAMES if (other / ("%s.cu" % n)).exists()]
    mods = {}
    for tag, csrc in (("this", _build.CSRC), ("other", other)):
        for name in names:
            mods[tag, name], spills = _wrapper(csrc, tag, name)
            print("%s %s: %s" % (tag, name, "; ".join(spills)))
    failed = False
    for name, label, args, call, compare in _cases(torch.device("cuda")):
        if name not in names:
            continue
        out, times = {}, {"this": [], "other": []}
        for tag in times:
            mod = mods[tag, name]
            out[tag] = call(mod, args)
            again = call(mod, args)
            torch.cuda.synchronize()
            if not torch.equal(out[tag], again):
                print("%s: %s tree differs on repeat" % (label, tag))
                failed = True
        ok, what = compare(out["this"], out["other"])
        failed |= not ok
        for r in range(opts.rounds):
            for tag in (("other", "this") if r % 2 == 0 else ("this", "other")):
                mod = mods[tag, name]
                times[tag].append(chip_smoke.cuda_ms(lambda: call(mod, args),
                                                     reps=10))
        med = {tag: float(np.median(t)) for tag, t in times.items()}
        print("%s: this vs other %s (%s); this %s ms; other %s ms; median of "
              "medians this %.4f, other %.4f (%+.1f%%)"
              % (label, what, "within" if ok else "PAST THE LIMIT",
                 " ".join("%.4f" % t for t in times["this"]),
                 " ".join("%.4f" % t for t in times["other"]),
                 med["this"], med["other"],
                 100 * (med["this"] / med["other"] - 1)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
