"""Compare the port's conv kernels, K2 (vggconv.cu) and K3 (resblock.cu), of
this checkout with those of another source tree, on one GPU.

    python3 scripts/torch_kernel_ab.py OTHER_CSRC [--rounds 6]

OTHER_CSRC is the `gandtr_tpu_torch/csrc` directory of another tree, e.g.
of a parent commit unpacked with `git archive` into a directory that
.gitignore lists. Each of the two kernels present in both trees is built
from each (the port's nvcc flags, into gandtr_tpu_torch/_build/ab/), run on
the same seeded inputs (K2 at the fine-tune's two shapes, bf16 out with
ReLU; K3 at the served block shape), checked bit-equal between the trees,
and timed alternately: `--rounds` CUDA-event medians of 10 calls each, the
other tree first in even rounds. Prints the card's name and power limit and
ptxas's spill report of each build; exits 1 if any output differs.
"""
import argparse
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gandtr_tpu_torch.kernels import _build  # noqa: E402
from gandtr_tpu_torch.kernels import resblock as kres  # noqa: E402
from gandtr_tpu_torch.kernels import vggconv as kvgg  # noqa: E402

KERNELS = {"vggconv": kvgg, "resblock": kres}


def _load(csrc, tag, name):
    """The wrapper's ctypes library built from `csrc`, and ptxas's spill
    lines."""
    mod = KERNELS[name]
    saved = _build.CSRC, _build.BUILD_DIR, mod._LIB
    _build.CSRC = pathlib.Path(csrc).resolve()
    _build.BUILD_DIR = ROOT / "gandtr_tpu_torch" / "_build" / "ab" / tag
    try:
        mod._LIB = None
        lib = mod._lib()
        so = _build.library_path(name)
        log = so.with_name(so.name + ".log")
        spills = ([line.strip() for line in log.read_text().splitlines()
                   if "spill" in line] if log.exists() else [])
    finally:
        _build.CSRC, _build.BUILD_DIR, mod._LIB = saved
    return lib, spills


def _cases(dev):
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    cases = []
    for shape in chip_smoke.K2_SHAPES[:2]:
        C = shape[-1]
        x, w = randn(*shape, scale=1.0), randn(9 * C, C, scale=0.05)
        b = torch.randn(C, generator=g, device=dev)
        cases.append(("vggconv", "K2 %s" % (shape,),
                      lambda x=x, w=w, b=b: kvgg.conv3x3_same_cuda(
                          x, w, b, relu=True)))
    N, H, W, C = chip_smoke.K3_SHAPES[0]
    args = (randn(N, H, W, C, scale=0.5), randn(9 * C, C, scale=0.05),
            randn(C, scale=0.1), randn(9 * C, C, scale=0.05),
            randn(C, scale=0.1))
    cases.append(("resblock", "K3 %s" % ((N, H, W, C),),
                  lambda: kres.fused_resblock_cuda(*args)))
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
    names = [n for n in KERNELS if (other / ("%s.cu" % n)).exists()]
    libs = {}
    for tag, csrc in (("this", _build.CSRC), ("other", other)):
        for name in names:
            libs[tag, name], spills = _load(csrc, tag, name)
            print("%s %s: %s" % (tag, name, "; ".join(spills)))
    failed = False
    for name, label, fn in _cases(torch.device("cuda")):
        if name not in names:
            continue
        mod = KERNELS[name]
        out, times = {}, {"this": [], "other": []}
        for tag in times:
            mod._LIB = libs[tag, name]
            out[tag] = fn()
        torch.cuda.synchronize()
        equal = torch.equal(out["this"], out["other"])
        failed |= not equal
        for r in range(opts.rounds):
            for tag in (("other", "this") if r % 2 == 0 else ("this", "other")):
                mod._LIB = libs[tag, name]
                times[tag].append(chip_smoke.cuda_ms(fn, reps=10))
        mod._LIB = None
        print("%s: bit-equal %s; this %s ms; other %s ms"
              % (label, equal, " ".join("%.4f" % t for t in times["this"]),
                 " ".join("%.4f" % t for t in times["other"])))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
