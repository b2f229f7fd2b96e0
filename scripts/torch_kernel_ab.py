"""Compare the port's kernels of this checkout with those of another source
tree, on one GPU: the conv kernels K2 (`kernels/vggconv.py`) and K3
(`kernels/resblock.py`), and the CLAHE kernels K1 (`kernels/clahe.py`) and
K4 (`kernels/clahe_masked.py`).

    python3 scripts/torch_kernel_ab.py OTHER_CSRC [--rounds 6]
                                       [--only clahe,clahe_masked]

OTHER_CSRC is the `gandtr_tpu_torch/csrc` directory of another tree, e.g.
of a parent commit unpacked with `git archive` into a directory that
.gitignore lists. Kernels are compared by wrapper, not by source: each
wrapper present in both trees (`gandtr_tpu_torch/kernels/<name>.py` beside
OTHER_CSRC) has its library built from its own tree's sources (the port's
nvcc flags, into gandtr_tpu_torch/_build/ab/) and is called as that tree
calls it, so the two trees may differ in their sources and C interfaces (a
wrapper that imports another wrapper of its package, as K4's imports K1's
launch, gets its own tree's). On the same seeded inputs (K2 at the
fine-tune's two shapes, bf16 out with ReLU; K3 at the served block shape;
K1 on a batch of 8 at 768x1024 and K4 on the fine-tune's (7, 364, 364)
bucket, clip 1.0, grid 8) each tree must be bit-equal on repeat, and the two trees must agree:
K1 and K4 bit for bit, K2 within 2e-2 of 1 + |y| (bf16 out) and K3 within
max 0.06 / mean 0.01 (a redesign sums in another order). Then both are
timed alternately: `--rounds` CUDA-event medians of windows of 10 calls (20
for CLAHE), the other tree first in even rounds. For the CLAHE kernels each
tree's call is also split into device and host time: the kernels'
durations by torch.profiler over 20 calls, the host clock around 200 calls
with no synchronise inside, and the kernels one call runs on the stream;
and the host's parts of a wrapper call are timed one by one. Prints the
card's name and power limit, ptxas's spill report of each build and the
median of each tree's medians; exits 1 past a limit or on a repeat that
differs.
"""
import argparse
import importlib.util
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gandtr_tpu_torch.kernels import _build  # noqa: E402

NAMES = ("vggconv", "resblock", "clahe", "clahe_masked")
K2_TOL = 2e-2                 # bf16 out, of 1 + |y|
K3_MAX, K3_MEAN = chip_smoke.K3_MAX, chip_smoke.K3_MEAN


def _wrapper(csrc, tag, name, siblings):
    """`name`'s wrapper module of the tree whose sources are `csrc`, its
    library built from them, and ptxas's spill lines. While it is imported,
    `siblings` ({name: module} of the same tree, loaded before it) stand in
    for the package's wrapper modules of those names, so a wrapper that
    imports another one gets its own tree's."""
    path = pathlib.Path(csrc).resolve().parent / "kernels" / ("%s.py" % name)
    spec = importlib.util.spec_from_file_location("ab_%s_%s" % (tag, name),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    keys = {"gandtr_tpu_torch.kernels.%s" % n: m for n, m in siblings.items()}
    saved = {k: sys.modules.get(k) for k in keys}
    sys.modules.update(keys)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, m in saved.items():
            if m is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = m
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC = pathlib.Path(csrc).resolve()
    _build.BUILD_DIR = ROOT / "gandtr_tpu_torch" / "_build" / "ab" / tag
    try:
        log = pathlib.Path(mod._lib()._name + ".log")
        spills = ([line.strip() for line in log.read_text().splitlines()
                   if "spill" in line] if log.exists() else [])
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    return mod, spills


def _equal(a, b):
    d = int((a.int() - b.int()).abs().max())
    return d == 0, "max |diff| %d" % d


def _cases(dev):
    """(wrapper name, label, inputs, call(module, inputs), compare)."""
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
    # chip_smoke.check_k1's batch and check_k4's bucket
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (chip_smoke.N_REQ,) + chip_smoke.HW, dtype=np.uint8)).to(dev)
    cases.append(("clahe", "K1 %s" % (tuple(img.shape),), (img,),
                  lambda m, a: m.clahe_u8_cuda(a[0], 1.0, 8), _equal))
    bucket, hw = chip_smoke.k4_batch(dev)
    cases.append(("clahe_masked", "K4 %s" % (tuple(bucket.shape),),
                  (bucket, hw),
                  lambda m, a: m.clahe_u8_masked_cuda(a[0], a[1], 1.0, 8),
                  _equal))
    return cases


def device_us(fn, calls=20):
    """Microseconds of kernel time on the card per `fn()`: the durations of
    the CUDA kernels torch.profiler records over `calls` calls, summed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.lower().startswith(("memset", "memcpy")))
    return total / calls if total else "not measured"


def host_us(fn, calls=200):
    """Microseconds of host clock per `fn()`, over `calls` calls with no
    synchronise inside (the card's queue absorbs them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * secs / calls


def host_parts(x, lib, calls=2000):
    """Host microseconds of each part a wrapper call may take, alone."""
    dev = x.device

    def per_call(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return 1e6 * (time.perf_counter() - t0) / calls

    def enter_device():
        with torch.cuda.device(dev):
            pass

    parts = {
        "torch.empty_like": lambda: torch.empty_like(x),
        "with torch.cuda.device(...)": enter_device,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "x.data_ptr()": x.data_ptr,
        "a ctypes call (1 int argument)": lambda: lib.clahe_error_string(0)
        if hasattr(lib, "clahe_error_string") else None,
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        parts["torch._C._cuda_getCurrentRawStream(i)"] = (
            lambda: raw(dev.index or 0))
    out = {k: per_call(fn) for k, fn in parts.items()}
    torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's gandtr_tpu_torch/csrc")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--only", default=",".join(NAMES),
                    help="comma-separated wrapper names (default: all)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    other = pathlib.Path(opts.other)
    names = [n for n in opts.only.split(",") if n in NAMES
             and (other.parent / "kernels" / ("%s.py" % n)).exists()]
    mods = {}
    for tag, csrc in (("this", _build.CSRC), ("other", other)):
        siblings = {}
        for name in names:
            mods[tag, name], spills = _wrapper(csrc, tag, name, siblings)
            siblings[name] = mods[tag, name]
            print("%s %s: %s" % (tag, name, "; ".join(spills)))
    failed = False
    for name, label, args, call, compare in _cases(torch.device("cuda")):
        if name not in names:
            continue
        clahe = name.startswith("clahe")
        reps = 20 if clahe else 10
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
                                                     reps=reps))
        med = {tag: float(np.median(t)) for tag, t in times.items()}
        print("%s: this vs other %s (%s); this %s ms; other %s ms; median of "
              "medians this %.4f, other %.4f (%+.1f%%)"
              % (label, what, "within" if ok else "PAST THE LIMIT",
                 " ".join("%.4f" % t for t in times["this"]),
                 " ".join("%.4f" % t for t in times["other"]),
                 med["this"], med["other"],
                 100 * (med["this"] / med["other"] - 1)))
        if not clahe:
            continue
        for tag in ("other", "this"):
            mod = mods[tag, name]

            def fn():
                return call(mod, args)

            dev_us, h_us = device_us(fn), host_us(fn)
            print("%s %s tree: event window %.2f us a call; device %s us a "
                  "call (torch.profiler, 20 calls); host %.2f us a call "
                  "(200 calls, no synchronise); kernels on the stream a "
                  "call: %s" % (label, tag, 1e3 * med[tag],
                                "%.2f" % dev_us if isinstance(dev_us, float)
                                else dev_us, h_us,
                                chip_smoke._stream_launches(fn)))
    if "clahe" in names:
        lib = mods["this", "clahe"]._lib()
        x = torch.empty((8, 768, 1024), dtype=torch.uint8, device="cuda")
        print("host parts of a wrapper call, us each (2000 calls): %s"
              % ", ".join("%s %.2f" % kv
                          for kv in host_parts(x, lib).items()))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
