"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA source of the port (gandtr_tpu_torch/csrc/*.cu, one
   nvcc each, all at once) into the ignored gandtr_tpu_torch/_build/,
   prints ptxas's register and spill report, and counts HGMMA (wgmma) and
   UTMALDG (TMA load) instructions in the conv kernels' SASS
   (`cuobjdump -sass`, where the toolkit has it): no HGMMA fails.
3. K1 (static CLAHE) against its plain PyTorch version on the card:
   bit-equal on a batch of 8 at 768x1024, a 29x35 and a 362x500 image, at
   grids 8 and 4; kernel and plain medians by CUDA events.
   K2 (VGG16's 64/128-channel 3x3 conv) against its plain version at the
   fine-tune's (7, 364, 364, 64) and (7, 182, 182, 128) and at (2, 30,
   26, 64) and (2, 15, 13, 128), bf16 and float32 out, with and without
   ReLU: within 2e-2 and 2e-5, bit-equal on repeat; its autograd backward
   against autograd of the plain conv under the kernel's ReLU mask; K2,
   plain, library (cuDNN bf16 conv + bias + ReLU) medians and the bound.
   K4 (masked CLAHE, LUT build + interpolation) against its plain version
   bit for bit on a (7, 364, 364) bucket of the fine-tune's rectangles,
   grids 8 and 4, clips 1.0 and 4.0; kernel and plain medians.
4. K3 (the fused ResNet block) against its plain version and the float32
   block, at the served block shape (8, 192, 256, 256) and at (2, 17, 23,
   64): within max 0.06 and mean 0.01, and two launches bit-equal; K3,
   plain and library (cuDNN bf16 convs + torch instance norm) medians, and
   the kernels one block call runs on the stream (torch.profiler).
5. One server (`serve_http` on 127.0.0.1) holds both models of the port:
   the GeM-VGG16 hub model (seeded random weights, full width, multiscale,
   a seeded Lw) and the cyclegan hub generator (seeded random weights, 9
   blocks, bf16 compute). Each path is driven with every launch count set
   to 0 just before it and read just after, with rounds of 8 concurrent
   npy `:predict` requests of 768x1024 uint8 images:
   - descriptors: finite, unit norm, equal to the direct `Servable` call,
     and (one image) within 1e-4 of the port on the CPU; K1 launched;
   - generator: PNGs that decode to uint8 (768, 1024, 3) and are byte-equal
     to the direct call's; K3 launched 9 times per batch formed.
6. Generator parity on the card: K3 swapped for its plain version in the
   bf16 generator, and the float32 generator (no K3) against the port on
   the CPU on one 256x256 image. With kaiming_p2p weights: within max 0.06
   and mean 0.01, and within 1e-4. With the served seeded normal_p2p
   weights, a chaotic net, within mean 0.01; the rest is printed beside
   the net's own response to a one-level input change.
7. The GeM fine-tune tuple step of finetune.yml (`FINETUNE`: the
   published network and learning sections, seeded weights, the embed in
   bf16) through `build_finetune_experiment` on `cuda`: T=5 tuples of 7
   uint8 images in a 364 bucket, the anchors of tuples 0, 2 and 4 through
   the frozen 9-block batch-norm generator; 2 warm-up steps, then 5 timed
   steps with every launch count set to 0 just before them: finite losses,
   every embed parameter moved, the generator untouched, float32 master
   parameters, K2 launched 10 and K4 5 times per step. Then one step's
   breakdown by CUDA events, and parity: the bf16 step with K2 and K4
   swapped for their plain versions (loss within 1%, descriptors within
   5e-3, the updated conv weights within 1e-4 of their size), and one
   float32 tuple on the card against the port on the CPU (within 1e-4).
8. Stage breakdowns of one batch of each served path, the `{"kernels":
   [...]}` line, the card's line again, and last `{"ok": true, "device":
   {...}}`.

Times are CUDA events around a window of back-to-back calls (`cuda_ms`).
Exits nonzero, printing no result, without CUDA or without the package.
"""
import io
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HW = (768, 1024)          # a 1024x768 (W x H) photo, the served shape
N_REQ = 8                 # concurrent requests per round
ROUNDS = 3                # timed rounds after one warm-up round
HBM_BYTES_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOP_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOP_S = 989e12      # H100 SXM dense bf16 tensor cores
K3_SHAPES = [(N_REQ, HW[0] // 4, HW[1] // 4, 256), (2, 17, 23, 64)]
K3_MAX, K3_MEAN = 0.06, 0.01   # tests/test_resblock_pallas.py:47-49
# the GeM fine-tune tuple step: T tuples of S images in a 364 bucket (the
# published image_size 362, rounded for the generator), with the
# rectangles imresize(., 362) leaves
BUCKET = 364
K4_RECTS = [(362, 241), (272, 362), (362, 362), (362, 203), (300, 362),
            (41, 57), (29, 35)]
K2_SHAPES = [(7, BUCKET, BUCKET, 64), (7, BUCKET // 2, BUCKET // 2, 128),
             (2, 30, 26, 64), (2, 15, 13, 128)]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2, runs=3):
    """Milliseconds of one `fn()` on the card: CUDA events around `reps`
    calls in a row (so the host's launch work overlaps the card's), the
    median over `runs` such windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def build_all():
    from gandtr_tpu_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    libs = _build.build(names)
    secs = time.perf_counter() - t0
    for name, so in libs.items():
        log = so.with_name(so.name + ".log")
        ptxas = log.read_text() if log.exists() else "(already built)"
        print("built %s -> %s" % (name, so.relative_to(ROOT)))
        for line in ptxas.splitlines():
            if ("registers" in line or "spill" in line or "wgmma" in line
                    or "setmaxnreg" in line or "error" in line.lower()):
                print("  " + line.strip())
    print("build: %d sources in %.1f s" % (len(names), secs))
    return libs


def sass_report(libs, names=("vggconv", "resblock")):
    """Whether each conv kernel's SASS has HGMMA (wgmma) and UTMALDG (TMA
    loads), from `cuobjdump -sass` of its built library; None where the
    toolkit has no cuobjdump."""
    from gandtr_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = {}
    for name in names:
        if not os.path.exists(tool):
            out[name] = None
            continue
        sass = subprocess.run([tool, "-sass", str(libs[name])],
                              capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            raise RuntimeError("cuobjdump failed on %s: %s"
                               % (name, sass.stderr[-2000:]))
        out[name] = {op: sass.stdout.count(op) for op in ("HGMMA", "UTMALDG")}
    print("SASS of the conv kernels (instruction counts): %s"
          % json.dumps(out))
    for name, counts in out.items():
        if counts is not None and not counts["HGMMA"]:
            raise AssertionError("%s has no HGMMA in its SASS" % name)
    return out


def _kernel_modules():
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.kernels import resblock as kres
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    return {"K1": kclahe, "K2": kvgg, "K3": kres, "K4": kmasked}


def reset_launches():
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0


def launches():
    return {k: mod.LAUNCHES for k, mod in _kernel_modules().items()}


def check_k1(dev):
    """K1 against its plain version, bit for bit; returns the max |diff|
    and the timings at the main path's shape."""
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.ops.clahe import clahe_u8_plain
    rng = np.random.RandomState(0)
    cases = [rng.randint(0, 256, (N_REQ,) + HW, dtype=np.uint8),
             rng.randint(0, 256, (29, 35), dtype=np.uint8),
             # smooth content with a narrow range: many clipped bins
             (np.add.outer(np.arange(362), np.arange(500)) % 64
              + rng.randint(0, 8, (362, 500))).astype(np.uint8)]
    worst = 0
    for img in cases:
        x = torch.from_numpy(img).to(dev)
        for grid, clip in [(8, 1.0), (4, 1.0), (8, 4.0)]:
            got = kclahe.clahe_u8_cuda(x, clip, grid)
            torch.cuda.synchronize()
            want = clahe_u8_plain(x, clip, grid)
            torch.cuda.synchronize()
            d = int((got.int() - want.int()).abs().max())
            worst = max(worst, d)
            print("K1 %-16s grid %d clip %.1f: max |kernel - plain| = %d"
                  % (tuple(img.shape), grid, clip, d))
    if worst:
        raise AssertionError("K1 differs from its plain version")
    x = torch.from_numpy(cases[0]).to(dev)
    ms = cuda_ms(lambda: kclahe.clahe_u8_cuda(x, 1.0, 8), reps=20)
    plain_ms = cuda_ms(lambda: clahe_u8_plain(x, 1.0, 8), reps=5)
    n, h, w = x.shape
    # each input byte read once, each output byte written once; per pixel
    # the interpolation's f32 work: two coordinate chains of a mul and two
    # subs, the two `1 - a`, 6 mul + 3 add in the lerp (the per-tile LUT
    # work is negligible beside it)
    nbytes = 2 * n * h * w
    flops = 17 * n * h * w
    bound_s = max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S)
    print("K1 at %s grid 8: kernel %.4f ms, plain %.4f ms, bound %.4f ms"
          % (tuple(x.shape), ms, plain_ms, bound_s * 1e3))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= flops / F32_FLOP_S else "operations")}


def _block_f32(x, w1, b1, w2, b2, eps=1e-5):
    """The float32 block (tests/test_resblock_pallas.py:12-25), NHWC."""
    import torch.nn.functional as F

    def conv(h, w, b):
        hp = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        return (F.conv2d(hp, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1) + b)

    def inorm(h):
        m = h.mean(dim=(1, 2), keepdim=True)
        v = ((h - m) ** 2).mean(dim=(1, 2), keepdim=True)
        return (h - m) / torch.sqrt(v + eps)

    h = torch.relu(inorm(conv(x, w1, b1)))
    return x + inorm(conv(h, w2, b2))


def _block_library(x, w1, b1, w2, b2, eps=1e-5):
    """The same block of PyTorch library calls (cuDNN bf16 convs, torch's
    instance norm), channels-last: timed beside K3, used nowhere."""
    import torch.nn.functional as F

    def conv(h, w, b):
        hp = F.pad(h, (1, 1, 1, 1), mode="reflect")
        return F.conv2d(hp.contiguous(memory_format=torch.channels_last), w,
                        b)

    h = torch.relu(F.instance_norm(conv(x, w1, b1), eps=eps))
    return x + F.instance_norm(conv(h, w2, b2), eps=eps)


def _stream_launches(fn):
    """Kernels the card ran for one `fn()`, by torch.profiler's CUDA events
    ("not measured" where the profiler sees none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.lower().startswith(("memset", "memcpy"))]
    return len(names) if names else "not measured"


def check_k3(dev):
    """K3 against its plain version and the float32 block; returns the
    errors and the timings at the served block shape."""
    from gandtr_tpu_torch.ops.resblock import (fused_resblock,
                                               fused_resblock_plain)
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for shape in K3_SHAPES:
        N, H, W, C = shape

        def randn(*s, scale):
            return (torch.randn(s, generator=g, device=dev) * scale).to(
                torch.bfloat16)

        # tests/test_resblock_pallas.py's _random_case scales, in bf16
        x = randn(N, H, W, C, scale=0.5)
        w1, w2 = randn(3, 3, C, C, scale=0.05), randn(3, 3, C, C, scale=0.05)
        b1, b2 = randn(C, scale=0.1), randn(C, scale=0.1)
        args = (x, w1, b1, w2, b2)
        got = fused_resblock(*args)
        again = fused_resblock(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("K3 is not deterministic at %s" % (shape,))
        errs = {}
        for ref_name, ref in (
                ("plain", fused_resblock_plain(*args).float()),
                ("f32 block", _block_f32(*(a.float() for a in args)))):
            d = (got.float() - ref).abs()
            errs[ref_name] = (float(d.max()), float(d.mean()))
            del d
        print("K3 %s: max/mean |kernel - plain| = %.5f / %.6f, "
              "|kernel - f32 block| = %.5f / %.6f, repeat bit-equal"
              % ((shape,) + errs["plain"] + errs["f32 block"]))
        for name, (mx, mean) in errs.items():
            if not (mx < K3_MAX and mean < K3_MEAN):
                raise AssertionError("K3 vs %s at %s: max %g mean %g"
                                     % (name, shape, mx, mean))
        if shape != K3_SHAPES[0]:
            continue
        out["max_abs_err"] = errs["plain"][0]
        out["ms"] = cuda_ms(lambda: fused_resblock(*args), reps=10)
        out["plain_ms"] = cuda_ms(lambda: fused_resblock_plain(*args),
                                  reps=3, warmup=1)
        cl = torch.channels_last
        xl = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW: channels-last
        lw1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=cl)
        lw2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)
        out["library_ms"] = cuda_ms(
            lambda: _block_library(xl, lw1, b1, lw2, b2), reps=10)
        flops = 2 * 2 * N * H * W * 9 * C * C
        nbytes = 2 * (2 * N * H * W * C + 2 * 9 * C * C + 2 * C)
        out["bound_ms"] = 1e3 * max(flops / BF16_FLOP_S,
                                    nbytes / HBM_BYTES_S)
        out["bound_by"] = ("operations" if flops / BF16_FLOP_S
                           >= nbytes / HBM_BYTES_S else "bytes")
        out["tflop_s"] = flops / out["ms"] / 1e9
        out["stream_launches"] = _stream_launches(
            lambda: fused_resblock(*args))
        print("K3 at %s: kernel %.3f ms (%.1f TFLOP/s), plain %.3f ms, "
              "library %.3f ms, bound %.4f ms (%s)"
              % (shape, out["ms"], out["tflop_s"], out["plain_ms"],
                 out["library_ms"], out["bound_ms"], out["bound_by"]))
        print("K3 launches per block call on the stream (torch.profiler): "
              "%s" % out["stream_launches"])
        del xl, lw1, lw2
    del x, w1, w2, b1, b2, args, got, again
    torch.cuda.empty_cache()
    return out


def _within(got, want, tol):
    """max |got - want| - tol * (1 + |want|) <= 0, and the max |diff|."""
    d = (got.float() - want.float()).abs()
    excess = float((d - tol * (1 + want.float().abs())).max())
    return excess <= 0, float(d.max())


def check_k2(dev):
    """K2 against its plain version (float32 sums of the same bf16 products)
    at the fine-tune path's two shapes and two ragged ones, bf16 and float32
    out, with and without ReLU: within 2e-5 (float32 out) and 2e-2 (bf16
    out) of 1 + |plain| (tests/test_vggconv_pallas.py:38, :51), and two
    launches bit-equal. Then Conv3x3Same's backward against autograd of the
    plain conv under the kernel's own ReLU mask, and the timings at the
    path's shapes (bf16 out, ReLU, as VGG16 calls it)."""
    import torch.nn.functional as F
    from gandtr_tpu_torch.device import set_float32_policy
    from gandtr_tpu_torch.kernels import vggconv as kvgg
    from gandtr_tpu_torch.ops.vggconv import conv3x3_same_plain
    set_float32_policy()        # the plain conv in full float32
    g = torch.Generator(device=dev).manual_seed(5)
    out = {"shapes": {}, "max_abs_err": 0.0}
    for shape in K2_SHAPES:
        N, H, W, C = shape
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((3, 3, C, C), generator=g, device=dev)
             / (3.0 * C ** 0.5)).to(torch.bfloat16)
        b = torch.randn((C,), generator=g, device=dev) * 0.1
        wmat = w.reshape(9 * C, C)
        for out_dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            for relu in (False, True):
                got = kvgg.conv3x3_same_cuda(x, wmat, b, relu, out_dtype)
                again = kvgg.conv3x3_same_cuda(x, wmat, b, relu, out_dtype)
                want = conv3x3_same_plain(x, w, b, relu, out_dtype)
                torch.cuda.synchronize()
                ok, err = _within(got, want, tol)
                print("K2 %-18s %-8s relu %d: max |kernel - plain| = %.3g, "
                      "repeat bit-equal %s"
                      % (shape, str(out_dtype).split(".")[1], relu, err,
                         torch.equal(got, again)))
                if not ok or not torch.equal(got, again):
                    raise AssertionError("K2 at %s %s relu %d: %g"
                                         % (shape, out_dtype, relu, err))
                if shape in K2_SHAPES[:2] and out_dtype == torch.bfloat16 \
                        and relu:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                del got, again, want
        if shape in (K2_SHAPES[1], K2_SHAPES[2]):
            _check_k2_backward(x, w, b, g)
        if shape not in K2_SHAPES[:2]:
            continue
        t = {"ms": cuda_ms(lambda: kvgg.conv3x3_same_cuda(
            x, wmat, b, True, torch.bfloat16), reps=20)}
        t["plain_ms"] = cuda_ms(lambda: conv3x3_same_plain(
            x, w, b, True, torch.bfloat16), reps=5)
        xl = x.permute(0, 3, 1, 2)     # NHWC memory seen as NCHW
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bl = b.to(torch.bfloat16)
        t["library_ms"] = cuda_ms(lambda: torch.relu(F.conv2d(
            xl, wl, bl, padding=1)), reps=20)
        flops = 2 * N * H * W * 9 * C * C
        nbytes = 2 * N * H * W * C * 2 + 9 * C * C * 2 + C * 4
        t["bound_ms"] = 1e3 * max(flops / BF16_FLOP_S, nbytes / HBM_BYTES_S)
        t["bound_by"] = ("operations" if flops / BF16_FLOP_S
                         >= nbytes / HBM_BYTES_S else "bytes")
        t["tflop_s"] = flops / t["ms"] / 1e9
        print("K2 at %s (bf16 out, ReLU): kernel %.4f ms (%.1f TFLOP/s), "
              "plain %.4f ms, library %.4f ms, bound %.4f ms (%s)"
              % (shape, t["ms"], t["tflop_s"], t["plain_ms"],
                 t["library_ms"], t["bound_ms"], t["bound_by"]))
        out["shapes"][str(shape)] = t
        del xl, wl
    # one tuple's K2 work: conv1_2 and conv2_2 each once
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        out[key] = sum(t[key] for t in out["shapes"].values())
    out["bound_by"] = "operations"
    torch.cuda.empty_cache()
    return out


def _check_k2_backward(x, w, b, g):
    """dx, dw, db of Conv3x3Same (K2 forward, ReLU, bf16 out) against
    autograd of the float32 conv of the same bf16 values, with the kernel's
    output > 0 as the ReLU mask: within 1% of the largest |gradient|."""
    import torch.nn.functional as F
    from gandtr_tpu_torch.ops.vggconv import Conv3x3Same
    xb = x.detach().clone().requires_grad_(True)
    wb = w.detach().clone().requires_grad_(True)
    bf = b.detach().clone().requires_grad_(True)
    co = torch.randn(x.shape, generator=g, device=x.device)
    y = Conv3x3Same.apply(xb, wb, bf, True, torch.bfloat16)
    (y.float() * co).sum().backward()
    mask = (y > 0).detach()
    xr = x.detach().float().requires_grad_(True)
    wr = w.detach().float().requires_grad_(True)
    br = b.detach().clone().requires_grad_(True)
    yr = F.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), br,
                  padding=1).permute(0, 2, 3, 1)
    (torch.where(mask, yr, 0.0) * co).sum().backward()
    errs = {}
    for name, got, want in (("dx", xb.grad, xr.grad), ("dw", wb.grad, wr.grad),
                            ("db", bf.grad, br.grad)):
        d = float((got.float() - want).abs().max())
        errs[name] = d / float(want.abs().max())
        if d > 0.01 * float(want.abs().max()) + 1e-6:
            raise AssertionError("K2 backward %s at %s: %g" % (
                name, tuple(x.shape), d))
    print("K2 backward at %s: max |autograd - plain autograd| / max |plain| "
          "= dx %.3g, dw %.3g, db %.3g" % ((tuple(x.shape),)
                                            + tuple(errs.values())))


def k4_batch(dev, seed=0):
    """A (7, 364, 364) uint8 bucket with the rectangles imresize(., 362)
    leaves, each smooth content plus noise (so some bins clip), zero band."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((len(K4_RECTS), BUCKET, BUCKET), np.uint8)
    for i, (h, w) in enumerate(K4_RECTS):
        yy, xx = np.mgrid[:h, :w]
        base = (yy * (3 + i) + xx * (5 - i)) % 97 + 60
        imgs[i, :h, :w] = np.clip(base + rng.randint(-40, 40, (h, w)), 0, 255)
    return (torch.from_numpy(imgs).to(dev),
            torch.tensor(K4_RECTS, dtype=torch.int32, device=dev))


def check_k4(dev):
    """K4 (masked LUT build + interpolation) against its plain version on
    the card, bit for bit (band included: both write 0 there), at grids 8
    and 4 and clips 1.0 and 4.0; two launches bit-equal; timings at the
    fine-tune's setting (clip 1.0, grid 8)."""
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.clahe import clahe_u8_masked_plain
    img, hw = k4_batch(dev)
    worst = 0
    for grid in (8, 4):
        for clip in (1.0, 4.0):
            got = kmasked.clahe_u8_masked_cuda(img, hw, clip, grid)
            again = kmasked.clahe_u8_masked_cuda(img, hw, clip, grid)
            want = clahe_u8_masked_plain(img, hw, clip, grid)
            torch.cuda.synchronize()
            d = int((got.int() - want.int()).abs().max())
            worst = max(worst, d)
            print("K4 %s grid %d clip %.1f: max |kernel - plain| = %d, "
                  "repeat bit-equal %s" % (tuple(img.shape), grid, clip, d,
                                           torch.equal(got, again)))
            if d or not torch.equal(got, again):
                raise AssertionError("K4 differs from its plain version")
    ms = cuda_ms(lambda: kmasked.clahe_u8_masked_cuda(img, hw, 1.0, 8),
                 reps=20)
    plain_ms = cuda_ms(lambda: clahe_u8_masked_plain(img, hw, 1.0, 8), reps=5)
    n, h, w = img.shape
    # each input byte read once, each output byte written once, hw read
    # once; per pixel the f32 work of the interpolation (as K1's)
    nbytes = 2 * n * h * w + hw.numel() * 4
    flops = 17 * n * h * w
    bound_s = max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S)
    print("K4 at %s grid 8: kernel %.4f ms, plain %.4f ms, bound %.5f ms"
          % (tuple(img.shape), ms, plain_ms, bound_s * 1e3))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= flops / F32_FLOP_S else "operations")}


def _post_npy(url, img):
    """POST one npy image; returns (content type, body bytes, seconds)."""
    buf = io.BytesIO()
    np.save(buf, img)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST",
                                 headers={"Content-Type":
                                          "application/octet-stream"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
        ctype = r.headers["Content-Type"]
    return ctype, body, time.perf_counter() - t0


def seeded_lw(dim=512, seed=1):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(dim, dim))
    return {"P": q.astype(np.float32),
            "m": (rng.randn(dim, 1) * 0.01).astype(np.float32)}


def serve_rounds(base, name, images):
    """Rounds of N_REQ concurrent :predict requests to model `name`; returns
    the (content type, body) answers of the last round in request order,
    and the timings of the rounds after the first."""
    url = base + "/v1/models/%s:predict" % name
    walls, lat, last = [], [], None
    for rnd in range(ROUNDS + 1):
        res = [None] * N_REQ
        errs = []

        def call(i):
            try:
                res[i] = _post_npy(url, images[i])
            except Exception as e:  # reported below, fails the run
                errs.append(e)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(N_REQ)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errs or any(t.is_alive() for t in threads):
            raise RuntimeError("requests to %s failed: %r" % (name, errs))
        last = [(r[0], r[1]) for r in res]
        if rnd:  # round 0 warms cuDNN, the allocator and the bf16 copy
            walls.append(wall)
            lat += [r[2] for r in res]
    return last, {
        "images_per_s": N_REQ * ROUNDS / sum(walls),
        "ms_per_request": 1e3 * float(np.mean(lat)),
        "ms_per_round": 1e3 * float(np.median(walls)),
    }


def conv_gflop(features, h, w):
    """Multiply-add FLOPs (2 per MAC) of the 3x3 same convolutions of
    `features` on one h x w image, from the layer shapes."""
    flop = 0
    for layer in features:
        if isinstance(layer, torch.nn.MaxPool2d):
            h, w = h // 2, w // 2
        elif isinstance(layer, torch.nn.Conv2d):
            flop += 2 * h * w * layer.in_channels * layer.out_channels * 9
    return flop / 1e9


def stage_breakdown(model, images):
    """CUDA-event times of one batch of N_REQ through the served descriptor
    forward, stage by stage (after the main path, so warm)."""
    from gandtr_tpu_torch.data.transforms import split_device_transform
    from gandtr_tpu_torch.ops.resize import scale_resize
    dp = model.net.data_params
    _, pre = split_device_transform(dp["transforms"], dp["mean_std"])
    module = model.net.module
    ctx = {"msp": model.meta["msp"]}
    out = {}
    with torch.inference_mode():
        out["upload_ms"] = cuda_ms(
            lambda: torch.from_numpy(images).to("cuda"), reps=5)
        xu = torch.from_numpy(images).to("cuda")
        out["preprocess_ms"] = cuda_ms(
            lambda: pre(xu.to(torch.float32) / 255.0), reps=5)
        xn = pre(xu.to(torch.float32) / 255.0)
        for s in (1.0, 1 / np.sqrt(2), 0.5):
            xs = xn if s == 1.0 else scale_resize(xn, s)
            ms = cuda_ms(lambda: module(xs), reps=5)
            gflop = conv_gflop(module.features, xs.shape[1], xs.shape[2])
            out["vgg16_gem_scale_%.3f_ms" % s] = ms
            out["vgg16_scale_%.3f_conv_tflop_s" % s] = (
                gflop * xs.shape[0] / ms)
        out["net_apply_ms"] = cuda_ms(lambda: model.net.apply(xn, ctx=ctx),
                                      reps=5)
    return out


def generator_breakdown(model, images, direct_ms, round_ms):
    """CUDA-event times of one batch of N_REQ through the served generator
    forward (bf16), stage by stage; the PNG + HTTP share is the round's
    wall time less the direct call's."""
    from gandtr_tpu_torch.data.transforms import (device_quantize_rgb,
                                                  split_device_transform)
    from gandtr_tpu_torch.serving.service import encode_png
    dp = model.net.data_params
    _, pre = split_device_transform(dp["transforms"], dp["mean_std"])
    seq = model.net.compute_module().model
    blocks = [i for i, m in enumerate(seq)
              if type(m).__name__ == "ResnetBlock"]
    head, body, tail = seq[:blocks[0]], seq[blocks[0]:blocks[-1] + 1], \
        seq[blocks[-1] + 1:]
    out = {}
    with torch.inference_mode():
        out["upload_ms"] = cuda_ms(
            lambda: torch.from_numpy(images).to("cuda"), reps=5)
        xu = torch.from_numpy(images).to("cuda")
        out["preprocess_ms"] = cuda_ms(
            lambda: pre(xu.to(torch.float32) / 255.0).to(torch.bfloat16),
            reps=5)
        x = pre(xu.to(torch.float32) / 255.0).to(torch.bfloat16)
        out["head_ms"] = cuda_ms(lambda: head(x), reps=5)
        h = head(x)
        out["nine_blocks_ms"] = cuda_ms(lambda: body(h), reps=5)
        h = body(h)
        out["tail_ms"] = cuda_ms(lambda: tail(h), reps=5)
        y = tail(h)
        out["quantize_ms"] = cuda_ms(
            lambda: device_quantize_rgb(y, dp["mean_std"]), reps=5)
        u8 = device_quantize_rgb(y, dp["mean_std"]).cpu().numpy()
    # as the server does it, one handler thread per request; and the same
    # at zlib level 1 (what a faster setting would save; not used)
    for key, level in (("png_encode_8_threads_ms", None),
                       ("png_encode_8_threads_level1_ms", 1)):
        def encode(img, level=level):
            if level is None:
                return encode_png(img)
            from PIL import Image
            Image.fromarray(img).save(io.BytesIO(), format="PNG",
                                      compress_level=level)
        threads = [threading.Thread(target=encode, args=(img,))
                   for img in u8]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out[key] = 1e3 * (time.perf_counter() - t0)
    out["png_bytes_per_image"] = float(np.mean([len(encode_png(i))
                                                for i in u8]))
    out["direct_servable_ms"] = direct_ms
    out["png_and_http_ms"] = round_ms - direct_ms
    return out


def _k3_vs_plain(model, x):
    """The bf16 generator's float output with K3 and with K3's plain version
    in the nine blocks; also the plain path's own change when one input
    value moves by one uint8 level (the net's sensitivity)."""
    from gandtr_tpu_torch.ops import resblock
    from gandtr_tpu_torch.ops.resblock import fused_resblock_plain
    with torch.inference_mode():
        with_k3 = model.net.apply(x).float()
        kernel = resblock.fused_resblock
        resblock.fused_resblock = fused_resblock_plain
        try:
            with_plain = model.net.apply(x).float()
            x1 = x.clone()
            x1[0, HW[0] // 2, HW[1] // 2, 0] += 2.0 / 255
            nudged = model.net.apply(x1).float()
        finally:
            resblock.fused_resblock = kernel
    d = (with_k3 - with_plain).abs()
    return (float(d.max()), float(d.mean()),
            float((nudged - with_plain).abs().max()))


def generator_parity(model, images):
    """K3 against its plain version inside the bf16 generator, and the
    float32 generator (no K3) on the card against the port on the CPU on one
    256x256 image.

    The served generator's seeded normal_p2p weights (std 0.2, about 7x the
    Kaiming scale of its 256-channel convs) make a chaotic net: one input
    value moved by one uint8 level moves its output by up to about 0.3, so
    the bf16 K3's summation order, which moves a block's output by a bf16
    step here and there, and float32 summation order on the card against
    the CPU, are amplified far beyond what the kernel or the convolutions
    do. There the K3 comparison is held to its mean bound and the rest is
    printed. The same architecture initialised with kaiming_p2p (the hedngan
    scheme), where a one-level input change moves the output by about 0.06,
    is held to every bound: K3 vs plain within max 0.06 and mean 0.01, the
    float32 net on the card within 1e-4 of the CPU."""
    from gandtr_tpu_torch import hub
    x = torch.from_numpy(images).to("cuda").float() / 127.5 - 1.0
    xs = torch.from_numpy(np.ascontiguousarray(images[:1, :256, :256]))
    xs = xs.float() / 127.5 - 1.0
    out = {}
    for init in ("normal_p2p", "kaiming_p2p"):
        served = init == "normal_p2p"
        gen = model if served else hub._generator(
            "instance", pretrained=False, init_weights=init)
        gen.net.compute_dtype = torch.bfloat16
        mx, mean, nudge = _k3_vs_plain(gen, x)
        cpu = hub._generator("instance", pretrained=False, init_weights=init,
                             device="cpu")
        with torch.inference_mode():
            d32 = float((gen.net.module(xs.to("cuda")).cpu()
                         - cpu.net.module(xs)).abs().max())
        print("generator %s%s: bf16, K3 vs its plain version in the 9 blocks "
              "on %d images of %dx%d: max %.5f mean %.6f (the plain path "
              "moved by one input level: max %.5f); float32 on the card vs "
              "the CPU port, 256x256: max %.3g"
              % (init, " (served)" if served else "", N_REQ, HW[0], HW[1],
                 mx, mean, nudge, d32))
        if mean >= K3_MEAN or not (served or (mx < K3_MAX and d32 <= 1e-4)):
            raise AssertionError("generator %s: K3 vs plain %g / %g, float32 "
                                 "card vs CPU %g" % (init, mx, mean, d32))
        out[init] = {"k3_vs_plain_max": mx, "k3_vs_plain_mean": mean,
                     "one_level_nudge_max": nudge,
                     "f32_card_vs_cpu_max": d32}
    del x
    torch.cuda.empty_cache()
    return out


MEANSTD_GEN = [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]
MEANSTD_IMNET = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
# gandtr_tpu/scenarios/configs/iccv23/parameters/finetune.yml as published
# (network, learning; data.train cut to what the step reads), with the
# published checkpoints out of reach: augment.path null (seeded normal_p2p
# weights), embed.model.pretrained false (seeded), and the embed computing
# in bf16 (runtime.dtype, as bench.py:378 runs it).
# tests/test_torch_finetune.py holds it to the YAML file.
FINETUNE = {
    "network": {
        "type": "CirSequentialNetwork",
        "sequence": "augment,embed",
        "augment": {
            "type": "SingleNetwork",
            "path": None,
            "model": {"architecture": "official_resnet_generator",
                      "no_antialias": True, "no_antialias_up": True,
                      "input_nc": 3, "output_nc": 3, "n_blocks": 9,
                      "norm_layer": "batch"},
            "runtime": {
                "frozen": True,
                "wrappers": ("meanstd_post:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:"
                             "[[0.485,0.456,0.406],[0.229,0.224,0.225]],"
                             "clahepost:[[0.5,0.5,0.5],[0.5,0.5,0.5]]:1.0,"
                             "cir_ratio_pass_through:0.25:anc"),
                "data": {"transforms": "pil2np | totensor | normalize",
                         "mean_std": MEANSTD_GEN}}},
        "embed": {
            "type": "SingleNetwork",
            "model": {"architecture": "cirnet", "cir_architecture": "vgg16",
                      "local_whitening": False, "pooling": "gem",
                      "pretrained": False, "regional": False,
                      "whitening": False},
            "initialize": False,
            "runtime": {
                "data": {"transforms": ("pil2np | apply_clahe:1.0 | "
                                        "totensor | normalize"),
                         "mean_std": MEANSTD_IMNET},
                "wrappers": "cirfaketuplebatch",
                "dtype": "bfloat16"}}},
    "learning": {
        "type": "TrainValLearning",
        "checkpoints": {
            "directory": "experiments/cirtorch/vgg16_${SCENARIO_NAME}",
            "checkpoint_every": 2, "store_every": 10},
        "training": {
            "type": "EpochTraining", "epochs": 40, "seed": 0,
            "deterministic": False, "dispatch_chunk": 8,
            "criterion": {"loss": "contrastive", "margin": 0.75},
            "epoch_iteration": {"type": "SupervisedEpoch",
                                "batch_average": False, "fakebatch": True,
                                "data": "train", "criterion": "default"},
            "optimizer": {"algorithm": "adam", "lr": 5.0e-07, "beta1": 0.9,
                          "beta2": 0.999, "weight_decay": 0.0005},
            "scheduler": {"algorithm": "gamma", "gamma": 0.99}}},
    "data": {"train": {"dataset": {"image_size": 362, "neg_num": 5},
                       "loader": {"batch_size": 5}}},
}
FT_T, FT_S = 5, 7              # tuples per step, images per tuple
FT_WARMUP, FT_STEPS = 2, 5
FT_LABELS = [-1, 1, 0, 0, 0, 0, 0]
FT_PASS = (0, 2, 4)            # tuples whose anchor takes the generator


def finetune_config(dtype="bfloat16"):
    import copy
    cfg = copy.deepcopy(FINETUNE)
    cfg["network"]["embed"]["runtime"]["dtype"] = dtype
    return cfg


def finetune_batch(dev, T=None, seed=0):
    """uint8 tuples (T, S, 364, 364, 3) of smooth content plus noise in the
    K4 rectangles (a different order in each tuple), their (h, w), the
    labels and the pass mask, on `dev`."""
    T = T or FT_T
    rng = np.random.RandomState(seed)
    imgs = np.zeros((T, FT_S, BUCKET, BUCKET, 3), np.uint8)
    hws = np.zeros((T, FT_S, 2), np.int32)
    for t in range(T):
        for s in range(FT_S):
            h, w = K4_RECTS[(s + t) % len(K4_RECTS)]
            yy, xx = np.mgrid[:h, :w]
            for c in range(3):
                base = (yy * (2 + s + c) + xx * (3 + t)) % 151 + 40
                imgs[t, s, :h, :w, c] = np.clip(
                    base + rng.randint(-30, 30, (h, w)), 0, 255)
            hws[t, s] = (h, w)
    labels = np.asarray([FT_LABELS] * T, np.float32)
    pmask = np.zeros((T, FT_S), bool)
    pmask[[t for t in FT_PASS if t < T], 0] = True
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (imgs, hws, labels, pmask))


def _descriptors(exp, x, masks, pmask, t=0):
    """Tuple t's descriptors (S, D) through the augment chain and the embed
    net, as the step computes them, without autograd."""
    models = exp["models"]
    with torch.no_grad():
        xa, ma = models["augment"].apply(
            x[t], ctx={"pass_mask": pmask[t]}, train=True,
            model_positions=(0,), mask=masks[t])
        return models["embed"].apply(xa, train=True, mask=ma).float()


def _embed_params(exp):
    return {k: v.detach().clone() for k, v in
            exp["models"]["embed"].module.named_parameters()}


def run_finetune(dev):
    """The fine-tune tuple step through its entry point: warm-up steps, then
    timed steps with every launch count set to 0 just before them."""
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    exp = build_finetune_experiment(finetune_config(), device=dev)
    batch = finetune_batch(dev)
    first = _embed_params(exp)
    aug_before = {k: v.clone() for k, v in
                  exp["models"]["augment"].module.state_dict().items()}
    state = exp["state"]
    for _ in range(FT_WARMUP):
        state, m = exp["step"](state, *batch)
    torch.cuda.synchronize()
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(FT_STEPS):
        state, m = exp["step"](state, *batch)
        losses.append(m["total"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    losses = [float(v) for v in losses]
    embed = exp["models"]["embed"].module
    moved = sum(int(not torch.equal(p.detach(), first[k]))
                for k, p in embed.named_parameters())
    aug_same = all(torch.equal(v, aug_before[k]) for k, v in
                   exp["models"]["augment"].module.state_dict().items())
    dtypes = sorted({str(p.dtype) for p in embed.parameters()})
    out = {"ms_per_step": 1e3 * secs / FT_STEPS,
           "images_per_s": FT_T * FT_S * FT_STEPS / secs,
           "losses": losses, "launches": counts,
           "embed_params_moved": moved,
           "embed_params": len(first), "master_dtypes": dtypes,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("fine-tune step (T=%d, S=%d, %d bucket, bf16 embed): %s"
          % (FT_T, FT_S, BUCKET, json.dumps(out)))
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite fine-tune loss %s" % losses)
    if moved != len(first) or not aug_same or dtypes != ["torch.float32"]:
        raise AssertionError("fine-tune update: %d of %d embed parameters "
                             "moved, augment unchanged %s, master %s"
                             % (moved, len(first), aug_same, dtypes))
    if counts["K2"] != 2 * FT_T * FT_STEPS or \
            counts["K4"] != FT_T * FT_STEPS:
        raise AssertionError("fine-tune launches %s over %d steps"
                             % (counts, FT_STEPS))
    return exp, batch, out


def conv_flops(module, fn):
    """Multiply-add FLOPs (2 per MAC) of the convolutions `fn()` runs in
    `module`, counted from the shapes they see (forward hooks)."""
    total = [0]

    def hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, torch.nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * k * m.out_channels // m.groups
        else:
            total[0] += 2 * out.numel() * k * m.in_channels // m.groups

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def finetune_breakdown(exp, batch):
    """CUDA-event times of one step's parts, the tuples' shares summed:
    staging, the generator on the anchors, the augment wrappers (meanstd,
    masked CLAHE by K4, the gate), the embed forward with the loss, the
    backward, the optimizer."""
    from gandtr_tpu_torch.ops import losses as L
    models = exp["models"]
    augment, embed = models["augment"], models["embed"]
    opt = exp["state"].optimizer
    imgs_u8, hws, labels, pmask = batch
    parts = {}
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    for rep in range(2):           # the second repetition is reported
        marks.clear()
        opt.zero_grad(set_to_none=True)
        mark("start")
        x, masks = exp["stage"](imgs_u8, hws)
        mark("stage")
        for t in range(x.shape[0]):
            with torch.no_grad():
                augment.module(x[t][:1], mask=masks[t][:1])
                mark("generator")
                augment.apply(x[t], ctx={"pass_mask": pmask[t]}, train=True,
                              model_positions=(), mask=masks[t])
                mark("wrappers")
                xa, ma = augment.apply(x[t], ctx={"pass_mask": pmask[t]},
                                       train=True, model_positions=(0,),
                                       mask=masks[t])
                mark("augment")
            d = embed.apply(xa, train=True, mask=ma)
            loss = L.contrastive_loss(d.T, labels[t], 1, margin=0.75)
            mark("embed_forward")
            loss.backward()
            mark("backward")
        opt.step()
        mark("optimizer")
        torch.cuda.synchronize()
    parts = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        parts[name] = parts.get(name, 0.0) + a.elapsed_time(b)
    total = marks[0][1].elapsed_time(marks[-1][1])
    # the "augment" mark re-ran the generator and the wrappers together, as
    # the step does; it is not part of one step's work
    step_ms = total - parts.pop("augment")
    out = {k + "_ms": v for k, v in parts.items()}
    out["step_ms"] = step_ms
    # the conv work of the step's generator and embed forwards, and its
    # rate over each part's time (K2's convs are counted by the hooks of
    # the conv modules whose weights they take, which they replace)
    with torch.no_grad():
        gen_flop = sum(conv_flops(augment.module, lambda t=t: augment.module(
            x[t][:1], mask=masks[t][:1])) for t in range(x.shape[0]))
    emb_flop = x.shape[0] * conv_flops(
        embed.module, lambda: _k2_free_embed(embed, x[0], masks[0]))
    out["generator_conv_gflop"] = gen_flop / 1e9
    out["generator_conv_tflop_s"] = gen_flop / parts["generator"] / 1e9
    out["embed_forward_conv_gflop"] = emb_flop / 1e9
    out["embed_forward_conv_tflop_s"] = (emb_flop / parts["embed_forward"]
                                         / 1e9)
    print("fine-tune breakdown (one step, T=%d, S=%d): %s"
          % (x.shape[0], x.shape[1], json.dumps(out)))
    return out


def _k2_free_embed(embed, x, mask):
    """The embed net's float32 forward on one tuple: every conv an
    nn.Conv2d call, so conv_flops sees the convs K2 runs on the path too."""
    with torch.no_grad():
        embed.module(x, mask=mask)


def finetune_parity(dev):
    """(a) The bf16 step with K2 and K4 swapped for their plain versions,
    on the same weights and batch: the loss within 1% relative, tuple 0's
    descriptors within 5e-3, and the updated conv weights' largest
    difference within 1e-4 of their largest value. (b) One tuple in float32 (no K2), on the
    card against the port on the CPU, the generator with kaiming_p2p
    weights: loss and descriptors within 1e-4. The seeded normal_p2p
    generator is a chaotic net (generator_parity), so its float32 summation
    order on the card against the CPU would show in its output, not the
    step's; the fine-tune's published generator is a trained one."""
    from gandtr_tpu_torch.models.init import initialize_weights
    from gandtr_tpu_torch.ops import clahe as clahe_ops
    from gandtr_tpu_torch.ops import vggconv
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    batch = finetune_batch(dev, T=2, seed=1)
    res = {}
    for name in ("kernels", "plain"):
        k2, k4 = vggconv.conv3x3_same, clahe_ops.clahe_u8_masked
        if name == "plain":
            vggconv.conv3x3_same = (lambda x, w, b=None, relu=False,
                                    out_dtype=None: vggconv.
                                    conv3x3_same_plain(x, w, b, relu,
                                                       out_dtype))
            clahe_ops.clahe_u8_masked = clahe_ops.clahe_u8_masked_plain
        try:
            reset_launches()
            exp = build_finetune_experiment(finetune_config(), device=dev)
            x, masks = exp["stage"](batch[0], batch[1])
            desc = _descriptors(exp, x, masks, batch[3])
            _, m = exp["step"](exp["state"], *batch)
            res[name] = (float(m["total"]), desc, _embed_params(exp),
                         launches())
        finally:
            vggconv.conv3x3_same, clahe_ops.clahe_u8_masked = k2, k4
    (lk, dk, pk, ck), (lp, dp, pp, cp) = res["kernels"], res["plain"]
    if cp["K2"] or cp["K4"] or not (ck["K2"] and ck["K4"]):
        raise AssertionError("parity launches: kernels %s, plain %s"
                             % (ck, cp))
    rel_loss = abs(lk - lp) / abs(lp)
    d_desc = float((dk - dp).abs().max())
    # Adam's first step moves each parameter by about lr (5e-7; 5e-6 for
    # GeM's p) whatever its gradient's size, so a gradient near 0 whose sign
    # differs moves a zero-initialised bias by 2 lr: the largest |diff| is
    # read in units of lr, and relative to the weights' own size
    lr = FINETUNE["learning"]["training"]["optimizer"]["lr"]
    d_par_lr = max(float((pk[k] - pp[k]).abs().max()) for k in pp) / lr
    d_par = max(float((pk[k] - pp[k]).abs().max() / pp[k].abs().max())
                for k in pp if pp[k].dim() > 1)
    print("fine-tune parity (bf16, K2 and K4 vs their plain versions, T=2): "
          "loss %.7g vs %.7g (rel %.3g), tuple-0 descriptors max |diff| "
          "%.3g; updated embed parameters: max |diff| %.3g lr, and over "
          "the conv weights max |diff| / max |weight| %.3g"
          % (lk, lp, rel_loss, d_desc, d_par_lr, d_par))
    if not (rel_loss <= 1e-2 and d_desc <= 5e-3 and d_par <= 1e-4):
        raise AssertionError("fine-tune kernels vs plain: loss %g desc %g "
                             "weights %g" % (rel_loss, d_desc, d_par))

    torch.set_num_threads(os.cpu_count() or 1)
    out32 = {}
    for d in (dev, torch.device("cpu")):
        b = tuple(a[:1].to(d) for a in batch)
        exp = build_finetune_experiment(finetune_config(None), device=d)
        initialize_weights(exp["models"]["augment"].module, "kaiming_p2p", 0)
        x, masks = exp["stage"](b[0], b[1])
        desc = _descriptors(exp, x, masks, b[3]).cpu()
        t0 = time.perf_counter()
        _, m = exp["step"](exp["state"], *b)
        loss = float(m["total"])
        out32[d.type] = (loss, desc, time.perf_counter() - t0)
    (lg, dg, _), (lc, dc, cpu_s) = out32["cuda"], out32["cpu"]
    d32 = float((dg - dc).abs().max())
    print("fine-tune float32, one tuple, card vs CPU port: loss %.8g vs %.8g "
          "(|diff| %.3g), descriptors max |diff| %.3g (CPU step %.1f s)"
          % (lg, lc, abs(lg - lc), d32, cpu_s))
    if abs(lg - lc) > 1e-4 or d32 > 1e-4:
        raise AssertionError("fine-tune float32 card vs CPU: loss %g desc %g"
                             % (abs(lg - lc), d32))
    torch.cuda.empty_cache()
    return {"bf16_loss_rel": rel_loss, "bf16_desc_max": d_desc,
            "bf16_param_max_lr": d_par_lr, "bf16_weight_max_rel": d_par,
            "f32_loss_abs": abs(lg - lc),
            "f32_desc_max": d32}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.serving.export import Servable
    from gandtr_tpu_torch.serving.service import encode_png, serve_http
    from PIL import Image

    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    sass_report(build_all())
    dev = torch.device("cuda")
    k1 = check_k1(dev)
    k2 = check_k2(dev)
    k4 = check_k4(dev)

    lw = seeded_lw()
    model = hub.gem_vgg16_hedngan(pretrained=False, whitening=lw)
    k3 = check_k3(dev)
    gen = hub.cyclegan(pretrained=False)
    gen.net.compute_dtype = torch.bfloat16
    images = np.random.RandomState(2).randint(
        0, 256, (N_REQ,) + HW + (3,), dtype=np.uint8)

    servable = Servable(model, HW)
    gen_servable = Servable(gen, HW)
    # a long batching window: each round's 8 requests form one batch, the
    # one the direct call below runs
    server = serve_http({"gem": servable, "gen": gen_servable}, port=0,
                        block=False, max_wait_ms=1000.0)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        print("healthz:", health)
        if health["device"] != "cuda" or health["status"] != "ok":
            raise AssertionError("server is not on the card: %r" % health)

        reset_launches()
        answers, timing = serve_rounds(base, "gem", images)
        desc_launches = launches()
        t0 = time.perf_counter()
        direct = servable(images)
        timing["direct_servable_ms"] = 1e3 * (time.perf_counter() - t0)

        reset_launches()
        batches0 = server.models["gen"].batcher.batches
        gen_answers, gen_timing = serve_rounds(base, "gen", images)
        gen_launches = launches()
        gen_batches = server.models["gen"].batcher.batches - batches0
        t0 = time.perf_counter()
        gen_direct = gen_servable(images)
        gen_timing["direct_servable_ms"] = 1e3 * (time.perf_counter() - t0)
    finally:
        server.close()

    # ---- descriptor path (the first slice's checks)
    print("descriptor path: launches %s for %d served images"
          % (desc_launches, N_REQ * (ROUNDS + 1)))
    if desc_launches["K1"] < 1:
        raise AssertionError("the descriptor path never launched K1")
    served = np.asarray([json.loads(body)["descriptor"]
                         for _, body in answers], np.float32)
    if not np.isfinite(served).all() or served.shape != (N_REQ, 512):
        raise AssertionError("bad descriptors %s" % (served.shape,))
    norms = np.linalg.norm(served, axis=1)
    if np.abs(norms - 1).max() > 1e-5:
        raise AssertionError("descriptor norms %s" % norms)
    # the batcher and the direct call run the same 8-image batch; a
    # different cuDNN algorithm choice could change float32 rounding only
    d_direct = float(np.abs(served - direct).max())
    if d_direct > 1e-5:
        raise AssertionError("served vs direct: %g" % d_direct)
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = hub.gem_vgg16_hedngan(pretrained=False, whitening=lw,
                                      device="cpu")
    t0 = time.perf_counter()
    cpu_desc = Servable(cpu_model, HW)(images[:1])
    cpu_s = time.perf_counter() - t0
    # TF32 is off on the card; float32 summation order and a possible
    # one-step flip of a uint8 lightness value remain
    d_cpu = float(np.abs(served[:1] - cpu_desc).max())
    print("served vs direct %.3g, served vs CPU port %.3g (CPU took %.1f s)"
          % (d_direct, d_cpu, cpu_s))
    if d_cpu > 1e-4:
        raise AssertionError("card vs CPU port: %g" % d_cpu)
    print("descriptor serving: %.3f images/s, %.2f ms per request, %.2f ms "
          "per round of %d; the direct Servable call on the same 8 took "
          "%.2f ms" % (timing["images_per_s"], timing["ms_per_request"],
                       timing["ms_per_round"], N_REQ,
                       timing["direct_servable_ms"]))
    breakdown = stage_breakdown(model, images)
    print("descriptor breakdown (batch %d at %dx%d): %s"
          % (N_REQ, HW[0], HW[1], json.dumps(breakdown)))

    # ---- generator path
    print("generator path: launches %s, %d batches formed, %d served images"
          % (gen_launches, gen_batches, N_REQ * (ROUNDS + 1)))
    if gen_launches["K3"] < 9 or gen_launches["K3"] != 9 * gen_batches:
        raise AssertionError("K3 launched %d times for %d batches"
                             % (gen_launches["K3"], gen_batches))
    for i, (ctype, body) in enumerate(gen_answers):
        png = np.asarray(Image.open(io.BytesIO(body)))
        if ctype != "image/png" or png.dtype != np.uint8 \
                or png.shape != HW + (3,):
            raise AssertionError("bad PNG %d: %s %s %s"
                                 % (i, ctype, png.dtype, png.shape))
        if body != encode_png(gen_direct[i]) or \
                not np.array_equal(png, gen_direct[i]):
            raise AssertionError("served PNG %d differs from the direct call"
                                 % i)
    print("generator PNGs: %d decode to uint8 %s and are byte-equal to the "
          "direct call" % (len(gen_answers), HW + (3,)))
    print("generator serving: %.3f images/s, %.2f ms per request, %.2f ms "
          "per round of %d; the direct Servable call on the same 8 took "
          "%.2f ms" % (gen_timing["images_per_s"],
                       gen_timing["ms_per_request"],
                       gen_timing["ms_per_round"], N_REQ,
                       gen_timing["direct_servable_ms"]))
    gen_breakdown = generator_breakdown(gen, images,
                                        gen_timing["direct_servable_ms"],
                                        gen_timing["ms_per_round"])
    print("generator breakdown (batch %d at %dx%d, bf16): %s"
          % (N_REQ, HW[0], HW[1], json.dumps(gen_breakdown)))
    parity = generator_parity(gen, images)
    print("generator parity: %s" % json.dumps(parity))
    del model, gen, servable, gen_servable, server
    torch.cuda.empty_cache()

    # ---- fine-tune tuple step
    torch.cuda.reset_peak_memory_stats()
    ft_exp, ft_batch, ft = run_finetune(dev)
    ft["breakdown"] = finetune_breakdown(ft_exp, ft_batch)
    del ft_exp, ft_batch
    torch.cuda.empty_cache()
    ft["parity"] = finetune_parity(dev)

    print(json.dumps({"kernels": [{
        "name": "clahe_u8 (K1: LUT + interpolation)",
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/clahe.cu",
        "replaces": "gandtr_tpu/ops/clahe_pallas.py:139",
        "launches": desc_launches["K1"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "kernel_ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_resblock (K3: conv3x3 + IN + ReLU + conv3x3 + IN + x)",
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/resblock.cu",
        "replaces": "gandtr_tpu/ops/resblock_pallas.py:109",
        "launches": gen_launches["K3"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }, {
        "name": ("conv3x3_same (K2: VGG16 conv1_2 + conv2_2 of one tuple, "
                 "bias + ReLU, bf16 out)"),
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/vggconv.cu",
        "replaces": "gandtr_tpu/ops/vggconv_pallas.py:94",
        "launches": ft["launches"]["K2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": "clahe_u8_masked (K4: masked LUT build + interpolation)",
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/clahe_masked.cu",
        "replaces": "gandtr_tpu/ops/clahe_pallas.py:289",
        "launches": ft["launches"]["K4"],
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
