"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA source of the port (gandtr_tpu_torch/csrc/*.cu, one
   nvcc each, all at once) into the ignored gandtr_tpu_torch/_build/,
   prints ptxas's register and spill report, and counts HGMMA (wgmma) and
   UTMALDG (TMA load) instructions in the conv kernels' SASS
   (`cuobjdump -sass`, where the toolkit has it): no HGMMA fails.
3. K1 (static CLAHE) against its plain PyTorch version on the card:
   bit-equal on a batch of 8 at 768x1024, a 29x35, a 362x500, a 3x5 and a
   32x37 image, at grids 8 and 4, two launches bit-equal, one kernel on the
   stream a call; kernel and plain medians by CUDA events.
   K2 (VGG16's 64/128-channel 3x3 conv) against its plain version at the
   fine-tune's (7, 364, 364, 64) and (7, 182, 182, 128) and at (2, 30,
   26, 64) and (2, 15, 13, 128), bf16 and float32 out, with and without
   ReLU: within 2e-2 and 2e-5, bit-equal on repeat; its autograd backward
   against autograd of the plain conv under the kernel's ReLU mask; K2,
   plain, library (cuDNN bf16 conv + bias + ReLU) medians and the bound.
   K4 (masked CLAHE, LUT build + interpolation) against its plain version
   bit for bit on a (7, 364, 364) bucket of the fine-tune's rectangles and
   a (4, 61, 75) one with 3x5 and 32x37 rectangles, grids 8 and 4, clips
   1.0 and 4.0, one kernel on the stream a call; kernel and plain medians.
   K1 and K4 are one kernel (csrc/clahe.cu) in static and masked mode.
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
8. The retrieval eval of parameters/eval.yml (`EVAL`: its network and
   data sections as shipped, GeM-VGG16 full width with seeded weights, a
   seeded 512x512 Lw pickle) through the port's validate stage on `cuda`,
   on a seeded synthetic roxford5k-style set written to a temp dir (48
   database JPEGs and 6 queries with bbx crops, photo sizes from 800x600
   to 1280x960, a gnd with easy / hard / junk lists). Twice: with
   `shape_bucket: 64` (masked chain, K4) and `null` (exact shapes, K1),
   each once to warm up and once with every launch count set to 0 just
   before it: descriptors finite and unit norm, bucketed within 1e-4 of
   exact, equal APs for the queries whose ranks agree, K4 (bucketed) or K1
   (exact) launched once per extracted batch; the stage's set-up timed
   alone. K4 and K1 on the very inputs the counted runs gave them (each
   distinct bucket and rectangles, or exact shape, once): bit-equal to
   the plain version, one kernel a call, timed against the bound. The
   card's busy share over the dataset's evaluation (set-up left out;
   torch.profiler) and the host's time in the extractor's calls there.
   Then the ranking on the card against numpy's float64 argsort, two
   database images against the port on the CPU (within 1e-4), and the
   host / device split per image.
9. The fine-tune loop of finetune.yml (`finetune_loop_config`: its
   network, learning, data and output sections, seeded weights, the embed
   in bf16; cut to 2 epochs, query_size 20, qpool_size 40, pool_size 150,
   checkpoint_every 1, store_every 2) through `build_finetune_experiment`
   and `training.run` on `cuda`, on a seeded synthetic tuple set in a temp
   dir (180 JPEGs in 60 clusters of 3, longest side 362, the reference's
   pkl form), every launch count set to 0 just before the run: finite
   losses, every embed parameter moved, the generator untouched, every
   mined negative outside its query's cluster and the others' clusters,
   K4 once and K2 twice for each mining extraction batch and each tuple.
   A fresh experiment on a copy of the directory as it was after epoch 1
   resumes at epoch 2 with the parameters and Adam moments bit-equal and
   trains it to finite losses; `embed_best.ckpt` loads strict into a fresh
   GeM-VGG16 whose descriptors equal the trained net's; the gate-
   partitioned extraction of 16 images within 5e-3 of one mixed batch.
   Printed: each epoch's mining, steps, checkpoint and events seconds, ms
   a step in the loop against the bare step of 7, the card's busy share
   over epoch 2's steps (torch.profiler), the loader threads' host ms a
   step, the extraction rate of each partition, the host seconds of one
   published epoch's mining on seeded random descriptors, and a labelled
   projection of a published epoch.
10. Stage breakdowns of one batch of each served path, the `{"kernels":
   [...]}` line (each kernel with its launches by path, K1 and K4 with
   their times at the eval's geometry), the card's line again, and last
   `{"ok": true, "device": {...}}`.

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


def _clahe_bound(shape, valid_px, n_sizes=0):
    """(bound seconds, "bytes" or "operations") of a CLAHE call on a uint8
    (N, H, W) buffer of which `valid_px` pixels are inside the images'
    rectangles: those read once, the whole buffer written once, the (N, 2)
    int32 sizes read once; the interpolation's 17 f32 operations a valid
    pixel (two coordinate chains of a mul and two subs, the two `1 - a`,
    6 mul + 3 add in the lerp; the per-tile LUT work is negligible)."""
    nbytes = valid_px + int(np.prod(shape)) + 4 * n_sizes
    flops = 17 * valid_px
    by_bytes = nbytes / HBM_BYTES_S >= flops / F32_FLOP_S
    return (max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S),
            "bytes" if by_bytes else "operations")


def _clahe_case(name, kernel, plain, shape, valid_px, n_sizes, per_call):
    """One CLAHE call on an eval input: bit-equal to its plain version, one
    kernel on the stream (`per_call`, as counted); kernel and plain medians
    and the bound."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    d = int((got.int() - want.int()).abs().max())
    if d or not torch.equal(got, kernel()) or per_call != 1:
        raise AssertionError("%s %s: max |kernel - plain| %d, %s kernels "
                             "a call" % (name, tuple(shape), d, per_call))
    ms = cuda_ms(kernel, reps=20)
    plain_ms = cuda_ms(plain, reps=3)
    bound_s, bound_by = _clahe_bound(shape, valid_px, n_sizes)
    print("%s %s: bit-equal to plain, 1 kernel a call; kernel %.4f ms, "
          "plain %.4f ms, bound %.5f ms (%s)"
          % (name, tuple(shape), ms, plain_ms, bound_s * 1e3, bound_by))
    return {"shape": list(shape), "max_abs_err": d, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by}


def check_k1(dev):
    """K1 against its plain version, bit for bit: a batch of 8 at 768x1024,
    a 29x35 image, smooth content, a 3x5 image (cv2's pad larger than the
    image), and a 32x37 one (H divides the grid, W does not: an extra tile
    row); one kernel on the stream a call; returns the max |diff| and the
    timings at the main path's shape."""
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.ops.clahe import clahe_u8_plain
    rng = np.random.RandomState(0)
    cases = [rng.randint(0, 256, (N_REQ,) + HW, dtype=np.uint8),
             rng.randint(0, 256, (29, 35), dtype=np.uint8),
             # smooth content with a narrow range: many clipped bins
             (np.add.outer(np.arange(362), np.arange(500)) % 64
              + rng.randint(0, 8, (362, 500))).astype(np.uint8),
             rng.randint(0, 256, (3, 5), dtype=np.uint8),
             rng.randint(0, 256, (2, 32, 37), dtype=np.uint8)]
    worst = 0
    for img in cases:
        x = torch.from_numpy(img).to(dev)
        for grid, clip in [(8, 1.0), (4, 1.0), (8, 4.0)]:
            got = kclahe.clahe_u8_cuda(x, clip, grid)
            again = kclahe.clahe_u8_cuda(x, clip, grid)
            want = clahe_u8_plain(x, clip, grid)
            torch.cuda.synchronize()
            d = int((got.int() - want.int()).abs().max())
            worst = max(worst, d)
            print("K1 %-16s grid %d clip %.1f: max |kernel - plain| = %d, "
                  "repeat bit-equal %s" % (tuple(img.shape), grid, clip, d,
                                           torch.equal(got, again)))
            if d or not torch.equal(got, again):
                raise AssertionError("K1 differs from its plain version")
    x = torch.from_numpy(cases[0]).to(dev)
    per_call = _stream_launches(lambda: kclahe.clahe_u8_cuda(x, 1.0, 8))
    print("K1 kernels on the stream a call (torch.profiler): %s" % per_call)
    if per_call != 1:
        raise AssertionError("K1 ran %s kernels in one call" % per_call)
    ms = cuda_ms(lambda: kclahe.clahe_u8_cuda(x, 1.0, 8), reps=20)
    plain_ms = cuda_ms(lambda: clahe_u8_plain(x, 1.0, 8), reps=5)
    bound_s, bound_by = _clahe_bound(x.shape, x.numel())
    print("K1 at %s grid 8: kernel %.4f ms, plain %.4f ms, bound %.4f ms"
          % (tuple(x.shape), ms, plain_ms, bound_s * 1e3))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "stream_launches": per_call,
            "bound_by": bound_by}


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


def _stream_launches(fn, tries=5):
    """Kernels the card ran for one `fn()`, by torch.profiler's CUDA events;
    a profile that records no kernel at all (the profiler drops one now and
    then) is taken again, up to `tries` times, then "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.lower().startswith(("memset", "memcpy"))]
        if names:
            return len(names)
    return "not measured"


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
    and 4 and clips 1.0 and 4.0, on the fine-tune's bucket and on a
    (4, 61, 75) one with a 3x5 rectangle (the pad larger than it), a 32x37
    one (h divides the grid, w does not: an extra tile row), a 40x64 one
    and the whole buffer; two launches bit-equal; one kernel on the stream
    a call; timings at the fine-tune's setting (clip 1.0, grid 8)."""
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.clahe import clahe_u8_masked_plain
    img, hw = k4_batch(dev)
    edge_rects = [(3, 5), (32, 37), (40, 64), (61, 75)]
    edge = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (len(edge_rects), 61, 75), dtype=np.uint8)).to(dev)
    edge_hw = torch.tensor(edge_rects, dtype=torch.int32, device=dev)
    worst = 0
    for x, xhw in ((img, hw), (edge, edge_hw)):
        for grid in (8, 4):
            for clip in (1.0, 4.0):
                got = kmasked.clahe_u8_masked_cuda(x, xhw, clip, grid)
                again = kmasked.clahe_u8_masked_cuda(x, xhw, clip, grid)
                want = clahe_u8_masked_plain(x, xhw, clip, grid)
                torch.cuda.synchronize()
                d = int((got.int() - want.int()).abs().max())
                worst = max(worst, d)
                print("K4 %s grid %d clip %.1f: max |kernel - plain| = %d, "
                      "repeat bit-equal %s" % (tuple(x.shape), grid, clip, d,
                                               torch.equal(got, again)))
                if d or not torch.equal(got, again):
                    raise AssertionError("K4 differs from its plain version")
    per_call = _stream_launches(
        lambda: kmasked.clahe_u8_masked_cuda(img, hw, 1.0, 8))
    print("K4 kernels on the stream a call (torch.profiler): %s" % per_call)
    if per_call != 1:
        raise AssertionError("K4 ran %s kernels in one call" % per_call)
    ms = cuda_ms(lambda: kmasked.clahe_u8_masked_cuda(img, hw, 1.0, 8),
                 reps=20)
    plain_ms = cuda_ms(lambda: clahe_u8_masked_plain(img, hw, 1.0, 8), reps=5)
    # the rectangles are read, the whole bucket written
    bound_s, bound_by = _clahe_bound(
        img.shape, sum(h * w for h, w in K4_RECTS), len(K4_RECTS))
    print("K4 at %s grid 8: kernel %.4f ms, plain %.4f ms, bound %.5f ms"
          % (tuple(img.shape), ms, plain_ms, bound_s * 1e3))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "stream_launches": per_call,
            "bound_by": bound_by}


def _kernels_a_call_fresh(cases):
    """Kernels on the stream for one call of each case [(module, function,
    args, kwargs)], counted by `_stream_launches` in a new process: in this
    one, once the served paths have run, the profiler's short traces come
    back empty more often than not."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="kernel_calls_") as d:
        path = os.path.join(d, "calls.pt")
        torch.save([(m, f, [a.cpu() if torch.is_tensor(a) else a
                            for a in args], kwargs)
                    for m, f, args, kwargs in cases], path)
        code = ("import json, sys; sys.path.insert(0, %r); "
                "import chip_smoke; "
                "print(json.dumps(chip_smoke._count_saved_calls(%r)))"
                % (str(ROOT), path))
        out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                             capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError("counting kernels a call failed: %s"
                           % out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def _count_saved_calls(path):
    """The child of `_kernels_a_call_fresh`."""
    import importlib
    sys.path.insert(0, str(ROOT))
    counts = []
    for module, name, args, kwargs in torch.load(path):
        fn = getattr(importlib.import_module(module), name)
        args = [a.cuda() if torch.is_tensor(a) else a for a in args]
        counts.append(_stream_launches(lambda: fn(*args, **kwargs)))
    return counts


def _recording_calls(module, name, calls):
    """Replace `module.<name>` by a wrapper that appends each call's
    (args, kwargs) to `calls` (the tensors by reference: no copy, no
    synchronisation) and calls it; returns a function that puts it back."""
    original = getattr(module, name)

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    setattr(module, name, recording)
    return lambda: setattr(module, name, original)


def check_clahe_at_eval(calls):
    """K4 and K1 on the inputs the counted eval runs gave them (`calls`:
    {"K4": [(args, kwargs)], "K1": [...]}): each distinct bucket shape and
    set of rectangles (K4) or exact shape (K1) once, bit-equal to the plain
    version with one kernel a call, timed against its bound. Returns
    {"K4": [case], "K1": [case]}, each case with the calls it stands for."""
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.clahe import (clahe_u8_masked_plain,
                                            clahe_u8_plain)
    wrappers = {"K4": kmasked.clahe_u8_masked_cuda,
                "K1": kclahe.clahe_u8_cuda}
    plains = {"K4": clahe_u8_masked_plain, "K1": clahe_u8_plain}
    distinct = {}
    for k in ("K4", "K1"):
        cases = {}
        for args, kwargs in calls[k]:
            rects = (tuple(map(tuple, args[1].tolist())) if k == "K4"
                     else ((args[0].shape[-2], args[0].shape[-1]),)
                     * (args[0].shape[0] if args[0].dim() == 3 else 1))
            key = (tuple(args[0].shape), rects) + tuple(args[2:]) \
                + tuple(sorted(kwargs.items()))
            cases.setdefault(key, [args, kwargs, 0])[2] += 1
        distinct[k] = sorted(cases.items(), key=lambda kv: str(kv[0]))
    per_call = iter(_kernels_a_call_fresh(
        [(wrappers[k].__module__, wrappers[k].__name__, args, kwargs)
         for k in distinct for _, (args, kwargs, _) in distinct[k]]))
    out = {}
    for k in distinct:
        out[k] = []
        for key, (args, kwargs, n) in distinct[k]:
            shape, rects = key[:2]
            case = _clahe_case(
                "%s eval %s, rectangles %s, %s" % (k, list(shape),
                                                   list(rects), key[2:]),
                lambda: wrappers[k](*args, **kwargs),
                lambda: plains[k](*args, **kwargs), shape,
                sum(h * w for h, w in rects), len(rects) if k == "K4" else 0,
                next(per_call))
            case.update(rects=[list(r) for r in rects], calls=n)
            out[k].append(case)
    return out


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
# parameters/eval.yml as shipped (tests/test_torch_eval.py holds it to the
# YAML): its `whitening: null` cannot run, so the eval phase points it at a
# seeded Lw pickle and `dir_main` at the synthetic set
EVAL = {
    "network": {
        "type": "SingleNetwork", "path": None,
        "model": {"architecture": "cirnet", "cir_architecture": "vgg16",
                  "pooling": "gem", "local_whitening": False,
                  "whitening": False, "regional": False},
        "runtime": {"wrappers": {"eval": {
            "0_cirwhiten": {"whitening": None, "dimensions": None},
            "1_cirmultiscale": {"scales": True}}}},
    },
    "data": {
        "image_size": 1024, "shape_bucket": 64,
        "transforms": "pil2np | apply_clahe:1.0 | totensor | normalize",
        "mean_std": MEANSTD_IMNET,
    },
    "validation": {"dir_main": "data/test",
                   "datasets": ["roxford5k", "rparis6k", "247tokyo1k"]},
}
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


# ---- the fine-tune loop of finetune.yml

# finetune.yml's data.train and output sections as published
# (tests/test_torch_finetune_loop.py holds finetune_loop_config to the YAML)
FINETUNE_DATA_TRAIN = {
    "dataset": {"name": "CirDiverseAnchors", "dataset": "retrieval-SfM-120k",
                "dataset_pkl": ("data/train/retrieval-SfM-120k/"
                                "retrieval-SfM-120k.pkl"),
                "image_dir": "data/train/retrieval-SfM-120k/ims",
                "image_size": 362, "neg_num": 5, "pool_size": 22000,
                "qpool_size": 10000, "query_size": 2000,
                "similar_exclude": 0.2, "similar_include": 0.8,
                "split": "train"},
    "loader": {"batch_size": 5}}
FINETUNE_OUTPUT = {"learning": {"progress": {"print_each": 100}}}
# the loop phase's cuts of scale (PERF.md §4); every other value published
LOOP_EPOCHS = 2
LOOP_CUTS = {"query_size": 20, "qpool_size": 40, "pool_size": 150}
LOOP_CHECKPOINTS = {"checkpoint_every": 1, "store_every": 2}
# the synthetic tuple set: 60 clusters of 3 photos, (h, w) with a longest
# side of 362, so imresize(., 362) keeps them
LOOP_CLUSTERS, LOOP_PER = 60, 3
LOOP_SHAPES = [(272, 362), (362, 272), (362, 362), (362, 204)]
# a published epoch: 2000 tuples / 5 a step, qpool 10,000 anchors (a
# quarter through the generator) and a pool of 22,000
PUB_STEPS, PUB_QPOOL, PUB_POOL, PUB_QUERIES = 400, 10000, 22000, 2000


def finetune_loop_config(dataset_pkl, image_dir):
    """finetune.yml with the seeded weights and bf16 embed of
    `finetune_config`, its data and output sections, and the loop's cuts."""
    import copy
    cfg = finetune_config()
    cfg["learning"]["training"]["epochs"] = LOOP_EPOCHS
    cfg["learning"]["checkpoints"].update(LOOP_CHECKPOINTS)
    cfg["data"] = {"train": copy.deepcopy(FINETUNE_DATA_TRAIN)}
    cfg["data"]["train"]["dataset"].update(
        LOOP_CUTS, dataset_pkl=dataset_pkl, image_dir=image_dir)
    cfg["output"] = copy.deepcopy(FINETUNE_OUTPUT)
    return cfg


def make_tuple_set(root, seed=0):
    """A seeded retrieval-SfM-style tuple set under root: LOOP_CLUSTERS
    clusters of LOOP_PER JPEGs (a scene of its own: a hue and 3 plane waves,
    each photo at another offset, with noise), shapes cycling through
    LOOP_SHAPES; root/db.pkl in the reference's form {"train": {"ids",
    "cluster", "qidxs", "pidxs"}}, each cluster's first photo a query and
    its second the positive. Returns the pkl's path."""
    import pickle
    from PIL import Image
    rng = np.random.RandomState(seed)
    ims = os.path.join(root, "ims")
    os.makedirs(ims)
    ids, cluster = [], []
    for c in range(LOOP_CLUSTERS):
        freq = rng.uniform(4, 30, (3, 2)) * rng.choice([-1, 1], (3, 2))
        phase = rng.uniform(0, 2 * np.pi, (3, 3))
        base = 0.5 + 0.25 * np.cos(2 * np.pi * (c / LOOP_CLUSTERS
                                                + np.array([0, 1, 2]) / 3))
        for k in range(LOOP_PER):
            h, w = LOOP_SHAPES[(c * LOOP_PER + k) % len(LOOP_SHAPES)]
            dy, dx = rng.uniform(0, 0.2, 2)
            yy = np.arange(h)[:, None, None] / 362.0 + dy
            xx = np.arange(w)[None, :, None] / 362.0 + dx
            img = np.broadcast_to(base, (h, w, 3)).copy()
            for j in range(3):
                img += 0.1 * np.sin(freq[j, 0] * yy + freq[j, 1] * xx
                                    + phase[j])
            img += rng.rand(h, w, 3) * 0.15
            name = "c%02d_%d.jpg" % (c, k)
            Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(ims, name), quality=90)
            ids.append(name)
            cluster.append(c)
    db = {"ids": ids, "cluster": cluster,
          "qidxs": [LOOP_PER * c for c in range(LOOP_CLUSTERS)],
          "pidxs": [LOOP_PER * c + 1 for c in range(LOOP_CLUSTERS)]}
    path = os.path.join(root, "db.pkl")
    with open(path, "wb") as f:
        pickle.dump({"train": db}, f)
    return path


def _extraction_batches(calls, images, ratio, label_re, batch):
    """The mining extraction batches of `calls` ([(idxs, label)]): each
    call's gated images and its others in batches of `batch` apart."""
    import re
    from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                    metadata_name)
    n = 0
    for idxs, label in calls:
        gate = re.match(label_re, label) is not None
        aug = sum(gate and cir_hash_passthrough(metadata_name(images[i]),
                                                ratio) for i in idxs)
        n += -(-aug // batch) + -(-(len(idxs) - aug) // batch)
    return n


def _instrument_loop(exp, rec):
    """Wrap the loop's parts on their instances to time them and record
    what the checks read: per epoch the mining, the steps (the epoch's run
    less its mining), the checkpoint save and the events, each ending on
    the host's wait; each loss; the extraction calls; the tuples; the host
    time the loader threads spend building tuples; torch.profiler over
    epoch 2's steps; and the state after epoch 1 with a copy of its
    directory."""
    import copy
    import shutil
    from torch.profiler import ProfilerActivity, profile
    training, dataset = exp["training"], exp["dataset"]
    loop = training.loop
    orig = {"prepare": dataset.prepare_epoch, "run": loop.run_epoch,
            "save": exp["checkpoints"].save_epoch,
            "norms": training._log_weight_norms,
            "close": exp["events"].close_epoch, "step": loop.step_fn,
            "extract": dataset.extract_fn, "hook": training.state_hook,
            "load": dataset._load_tuple_u8, "args": loop.batch_to_args}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            rec["epochs"][-1][key] += time.perf_counter() - t0
            return out
        return wrapper

    def prepare():
        t0 = time.perf_counter()
        out = orig["prepare"]()
        torch.cuda.synchronize()
        rec["epochs"][-1]["mining_s"] += time.perf_counter() - t0
        rec["tuples"].append(list(dataset.tuples))
        rec["marks"].append([("mined", time.perf_counter())])
        if len(rec["epochs"]) == 2:
            rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
            rec["prof"].__enter__()
            rec["prof_t0"] = time.perf_counter()
        return out

    def run_epoch(state, epoch):
        rec["epochs"].append(dict.fromkeys(
            ("mining_s", "run_s", "checkpoint_s", "events_s"), 0.0))
        t0 = time.perf_counter()
        state = orig["run"](state, epoch)
        rec["epochs"][-1]["run_s"] = time.perf_counter() - t0
        if epoch == 2:
            torch.cuda.synchronize()
            rec["prof_wall"] = time.perf_counter() - rec["prof_t0"]
            rec["prof"].__exit__(None, None, None)
        return state

    def step_fn(state, *args):
        state, m = orig["step"](state, *args)
        rec["losses"].append(m["total"])
        rec["marks"][-1].append(("stepped", time.perf_counter()))
        return state, m

    def batch_to_args(batch):
        rec["marks"][-1].append(("batch", time.perf_counter()))
        return orig["args"](batch)

    def extract(idxs, label="anc-mine"):
        rec["extract_calls"].append((list(idxs), label))
        return orig["extract"](idxs, label=label)

    def load(idxs):
        t0 = time.perf_counter()
        out = orig["load"](idxs)
        rec["loader_s"].append(time.perf_counter() - t0)
        return out

    def hook(state, epoch):
        if epoch == 1:
            embed = state.models["embed"].module
            rec["after1"] = {
                "params": {k: p.detach().clone()
                           for k, p in embed.named_parameters()},
                "optimizer": copy.deepcopy(state.optimizer.state_dict()),
                "step": state.step}
            shutil.copytree(exp["checkpoints"].directory, rec["copy_dir"],
                            symlinks=True)
        return orig["hook"](state, epoch)

    dataset.prepare_epoch = prepare
    dataset.extract_fn = extract
    extract.holder = orig["extract"].holder
    dataset._load_tuple_u8 = load
    loop.run_epoch = run_epoch
    loop.step_fn = step_fn
    loop.batch_to_args = batch_to_args
    exp["checkpoints"].save_epoch = timed("checkpoint_s", orig["save"])
    training._log_weight_norms = timed("events_s", orig["norms"])
    exp["events"].close_epoch = timed("events_s", orig["close"])
    training.state_hook = hook


def _partition_check(exp, images, dev):
    """The gate-partitioned extraction of 16 images (8 through the
    generator, 8 not) against one mixed batch of them through the same
    chain: max |diff| (the bf16 bound of the step, 5e-3)."""
    from gandtr_tpu_torch.data.cir_datasets import load_u8_padded
    from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                    metadata_name)
    flags = [cir_hash_passthrough(metadata_name(p), 0.25) for p in images]
    gated = [i for i, f in enumerate(flags) if f][:8]
    plain = [i for i, f in enumerate(flags) if not f][:8]
    idxs = [i for pair in zip(gated, plain) for i in pair]
    got = exp["dataset"].extract_fn(idxs, label="anc-mine")
    ds = exp["dataset"]
    arrs, hws = zip(*(load_u8_padded(images[i], ds.image_size, ds.pad_size)
                      for i in idxs))
    models = exp["models"]
    with torch.inference_mode():
        x, m = exp["stage"](
            torch.from_numpy(np.stack(arrs))[None].to(dev),
            torch.from_numpy(np.asarray(hws, np.int32))[None].to(dev))
        y, m = models["augment"].apply(
            x[0], ctx={"pass_mask": torch.tensor([flags[i] for i in idxs],
                                                 device=dev)},
            train=True, mask=m[0])
        want = models["embed"].apply(y, train=False, mask=m).float()
    return float(np.abs(got - want.cpu().numpy().T).max())


def _extraction_rates(exp, images):
    """Images a second of the mining extraction, for the generator
    partition (the gated images, label anc-mine) and the pass-through one
    (the others, label neg-pool-mine), each a warm call ending in the
    host's copy of the descriptors."""
    from gandtr_tpu_torch.learning.wrappers import (cir_hash_passthrough,
                                                    metadata_name)
    flags = [cir_hash_passthrough(metadata_name(p), 0.25) for p in images]
    out = {}
    for name, idxs, label in (
            ("generator", [i for i, f in enumerate(flags) if f], "anc-mine"),
            ("pass_through", [i for i, f in enumerate(flags) if not f][:128],
             "neg-pool-mine")):
        exp["dataset"].extract_fn(idxs[:8], label=label)
        t0 = time.perf_counter()
        exp["dataset"].extract_fn(idxs, label=label)
        out[name] = {"images": len(idxs),
                     "images_per_s": len(idxs) / (time.perf_counter() - t0)}
    return out


def protocol_mining(dev, seed=0):
    """Host seconds of one published epoch's mining on seeded random unit
    descriptors: rank_descriptors of (512, 22,000) pool against (512,
    2,000) queries on the card plus search_hard_negatives with nnum 5, and
    select_diverse_queries picking 2,000 of a 10,000 pool."""
    from gandtr_tpu_torch.data import mining
    rng = np.random.RandomState(seed)

    def unit(n):
        v = rng.randn(512, n).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    qpool, pool = unit(PUB_QPOOL), unit(PUB_POOL)
    clusters = list(np.arange(PUB_QPOOL + PUB_POOL) // 10)
    t0 = time.perf_counter()
    sel, _ = mining.select_diverse_queries(qpool, PUB_QUERIES, 0.2, 0.8,
                                           rng=np.random.RandomState(seed))
    select_s = time.perf_counter() - t0
    qidxs = sel
    idxs2images = list(range(PUB_QPOOL, PUB_QPOOL + PUB_POOL))
    t0 = time.perf_counter()
    nidxs, _ = mining.search_hard_negatives(
        qpool[:, sel], pool, qidxs, idxs2images, clusters, 5, device=dev)
    search_s = time.perf_counter() - t0
    if len(set(sel)) != PUB_QUERIES or any(len(n) != 5 for n in nidxs):
        raise AssertionError("protocol mining picked %d queries"
                             % len(set(sel)))
    return {"select_diverse_queries_s": select_s,
            "rank_and_search_s": search_s,
            "host_mining_s": select_s + search_s}


def run_finetune_loop(dev, bare_step_ms):
    """finetune.yml's loop through build_finetune_experiment on the card:
    two epochs on a seeded synthetic tuple set (the cuts of LOOP_CUTS),
    every launch count set to 0 just before `training.run` and read just
    after; then the checks, the resume, the extraction rates, the mining
    at protocol scale and the projection of a published epoch."""
    import shutil
    import tempfile
    from gandtr_tpu_torch.learning.network import build_single_net
    from gandtr_tpu_torch.scenarios.finetune_build import (
        EXTRACT_BATCH, build_finetune_experiment)
    tmp = tempfile.mkdtemp(prefix="ftloop_", dir=os.environ.get("TMPDIR"))
    try:
        t0 = time.perf_counter()
        pkl = make_tuple_set(tmp)
        cfg = finetune_loop_config(pkl, os.path.join(tmp, "ims"))
        exp = build_finetune_experiment(cfg, os.path.join(tmp, "exp"),
                                        device=dev)
        setup_s = time.perf_counter() - t0
        images = exp["dataset"].images
        rec = {"epochs": [], "losses": [], "tuples": [], "extract_calls": [],
               "loader_s": [], "marks": [],
               "copy_dir": os.path.join(tmp, "exp_after1")}
        _instrument_loop(exp, rec)
        first = {k: v.detach().clone() for k, v in
                 exp["models"]["embed"].module.named_parameters()}
        aug0 = {k: v.clone() for k, v in
                exp["models"]["augment"].module.state_dict().items()}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = exp["training"].run(exp["state"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()

        # --- what the run must show
        losses = [float(v) for v in rec["losses"]]
        steps = len(losses)
        per_epoch = len(exp["loader"])
        if steps != LOOP_EPOCHS * per_epoch or not np.all(np.isfinite(losses)):
            raise AssertionError("loop losses %s" % losses)
        embed = state.models["embed"].module
        moved = sum(int(not torch.equal(p.detach(), first[k]))
                    for k, p in embed.named_parameters())
        aug_same = all(torch.equal(v, aug0[k]) for k, v in
                       state.models["augment"].module.state_dict().items())
        if moved != len(first) or not aug_same:
            raise AssertionError("loop update: %d of %d embed parameters "
                                 "moved, augment unchanged %s"
                                 % (moved, len(first), aug_same))
        clusters = exp["dataset"].db["cluster"]
        for tuples in rec["tuples"]:
            for q, _, negs in tuples:
                if len(negs) != 5 or len({clusters[n] for n in negs}
                                         | {clusters[q]}) != 6:
                    raise AssertionError("negatives of %d: %s" % (q, negs))
        batches = _extraction_batches(rec["extract_calls"], images, 0.25,
                                      "anc", EXTRACT_BATCH)
        t = cfg["data"]["train"]["loader"]["batch_size"]
        want = {"K2": 2 * (batches + t * steps), "K4": batches + t * steps}
        if (counts["K2"], counts["K4"]) != (want["K2"], want["K4"]):
            raise AssertionError("loop launches %s, expected %s (%d "
                                 "extraction batches, %d steps of %d tuples)"
                                 % (counts, want, batches, steps, t))
        print("fine-tune loop launches: %s = K4 once and K2 twice for each "
              "of %d mining extraction batches and each of %d tuples in %d "
              "steps" % (json.dumps(counts), batches, t * steps, steps))

        # --- the parts of the run and the card's busy share
        prof = rec.pop("prof")
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        ep2 = rec["epochs"][1]
        steps_s = ep2["run_s"] - ep2["mining_s"]
        loop_step_ms = 1e3 * steps_s / per_epoch
        # epoch 2 on the host's clock: the wait for the first batch after
        # mining, and the host's time from one step's return to the next's
        marks = rec["marks"][1]
        first = next(t for k, t in marks if k == "batch") - marks[0][1]
        stepped = [t for k, t in marks if k == "stepped"]
        out = {"setup_s": setup_s, "run_s": wall, "steps": steps,
               "losses": losses, "launches": counts,
               "extraction_batches": batches,
               "epochs": [{"mining_s": e["mining_s"],
                           "steps_s": e["run_s"] - e["mining_s"],
                           "checkpoint_s": e["checkpoint_s"],
                           "events_s": e["events_s"]}
                          for e in rec["epochs"]],
               "loop_ms_per_step_epoch2": loop_step_ms,
               "bare_step_ms": bare_step_ms,
               "epoch2_first_batch_wait_ms": 1e3 * first,
               "epoch2_host_ms_between_steps": 1e3 * float(
                   np.mean(np.diff(stepped))),
               "epoch2_steps_busy_share": busy_us / 1e6 / rec["prof_wall"],
               "epoch2_steps_profiled_wall_s": rec["prof_wall"],
               "loader_host_ms_per_step": 1e3 * sum(rec["loader_s"]) / steps,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

        # --- resume from the directory as it was after epoch 1
        rexp = build_finetune_experiment(cfg, rec["copy_dir"], device=dev)
        rstate, start = rexp["training"].resume_or_start(rexp["state"])
        after1 = rec["after1"]
        same_params = all(torch.equal(p.detach(), after1["params"][k]) for k, p
                          in rstate.models["embed"].module.named_parameters())
        got_opt = rstate.optimizer.state_dict()["state"]
        same_moments = all(torch.equal(got_opt[i][k], v)
                           for i, s in after1["optimizer"]["state"].items()
                           for k, v in s.items())
        if start != 2 or rstate.step != after1["step"] or not (
                same_params and same_moments):
            raise AssertionError("resume: start %d, step %d vs %d, params "
                                 "%s, moments %s" % (start, rstate.step,
                                                     after1["step"],
                                                     same_params,
                                                     same_moments))
        rlosses = []
        rstep = rexp["training"].loop.step_fn

        def counted(s, *args):
            s, m = rstep(s, *args)
            rlosses.append(m["total"])
            return s, m

        rexp["training"].loop.step_fn = counted
        rexp["training"].run(rstate, start_epoch=start)
        rlosses = [float(v) for v in rlosses]
        if len(rlosses) != per_epoch or not np.all(np.isfinite(rlosses)):
            raise AssertionError("resumed epoch 2 losses %s" % rlosses)
        out["resume"] = {"start_epoch": start, "params_bit_equal": True,
                         "adam_moments_bit_equal": True,
                         "epoch2_losses": rlosses}
        del rexp, rstate

        # --- embed_best.ckpt in a fresh GeM-VGG16, and mining after the
        # steps against it (the bf16 cast copy follows the weights)
        best = exp["checkpoints"].load_net("embed", "_best")
        fresh = build_single_net(cfg["network"]["embed"], device="cpu")
        fresh.module.load_state_dict(best["model_state"], strict=True)
        fresh.module.to(dev)
        from gandtr_tpu_torch.data.cir_datasets import load_u8_padded
        ds = exp["dataset"]
        arrs, hws = zip(*(load_u8_padded(images[i], ds.image_size,
                                         ds.pad_size) for i in range(8)))
        with torch.inference_mode():
            x, m = exp["stage"](
                torch.from_numpy(np.stack(arrs))[None].to(dev),
                torch.from_numpy(np.asarray(hws, np.int32))[None].to(dev))
            d_trained = exp["models"]["embed"].apply(x[0], train=False,
                                                     mask=m[0])
            d_fresh = fresh.apply(x[0], train=False, mask=m[0])
        if not torch.equal(d_trained, d_fresh):
            raise AssertionError("embed_best.ckpt descriptors differ by %g"
                                 % float((d_trained.float()
                                          - d_fresh.float()).abs().max()))
        del fresh

        out["partition_vs_one_batch_max"] = _partition_check(exp, images,
                                                             dev)
        if out["partition_vs_one_batch_max"] > 5e-3:
            raise AssertionError("partitioned extraction vs one batch: %g"
                                 % out["partition_vs_one_batch_max"])
        out["extraction"] = _extraction_rates(exp, images)
        out["protocol_mining"] = protocol_mining(dev)
        del exp, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    gen_rate = out["extraction"]["generator"]["images_per_s"]
    plain_rate = out["extraction"]["pass_through"]["images_per_s"]
    gated = PUB_QPOOL // 4
    proj = {"steps_s": PUB_STEPS * loop_step_ms / 1e3,
            "extraction_generator_s": gated / gen_rate,
            "extraction_pass_through_s": (PUB_QPOOL - gated + PUB_POOL)
            / plain_rate,
            "host_mining_s": out["protocol_mining"]["host_mining_s"]}
    proj["epoch_s"] = sum(proj.values())
    out["projection_published_epoch"] = proj
    print("fine-tune loop (finetune.yml, 2 epochs, query_size 20, qpool_size "
          "40, pool_size 150, bf16 embed): %s" % json.dumps(out))
    print("PROJECTION, not a measurement: a published epoch (400 steps, "
          "32,000 mining extractions of which 2,500 through the generator, "
          "mining at 2,000 x 22,000) from this run's rates: %s"
          % json.dumps(proj))
    return out


# ---- the retrieval eval of eval.yml

EVAL_SHAPES = [(768, 1024), (1024, 768), (683, 1024), (1024, 683),
               (576, 1024), (600, 800), (960, 1280)]   # (h, w) photos
EVAL_DB, EVAL_Q = 48, 6


def make_eval_set(root, seed=0):
    """A seeded synthetic roxford5k-style set under root/roxford5k: EVAL_Q
    scenes, each seen by one query (cropped to a bbx) and by EVAL_DB //
    EVAL_Q database photos at other offsets, with noise; sizes cycle through
    EVAL_SHAPES (1280x960 is downsized by LANCZOS, 800x600 kept). Each
    query's gnd lists 4 easy, 3 hard and 1 junk photo of its scene. Returns
    the database paths."""
    import pickle
    from PIL import Image
    rng = np.random.RandomState(seed)
    jpg = os.path.join(root, "roxford5k", "jpg")
    os.makedirs(jpg)
    # a scene: a hue of its own and 4 plane waves, in units of the photo's
    # longest side (so a downsized photo shows the same scene)
    hues = np.linspace(0, 1, EVAL_Q, endpoint=False)
    scenes = [((rng.uniform(2, 14, (4, 2)) * rng.choice([-1, 1], (4, 2))
                * 2 * np.pi).astype(np.float32),
               rng.uniform(0, 2 * np.pi, (4, 3)).astype(np.float32),
               (0.5 + 0.25 * np.cos(2 * np.pi * (hues[k] + np.array(
                   [0, 1 / 3, 2 / 3])))).astype(np.float32))
              for k in range(EVAL_Q)]

    def photo(scene, h, w, path):
        freq, phase, base = scenes[scene]
        side = float(max(h, w))
        dy, dx = rng.uniform(0, 0.3, 2).astype(np.float32)
        yy = np.arange(h, dtype=np.float32)[:, None, None] / side + dy
        xx = np.arange(w, dtype=np.float32)[None, :, None] / side + dx
        img = np.broadcast_to(base, (h, w, 3)).copy()
        for k in range(len(freq)):
            img += np.float32(0.08) * np.sin(freq[k, 0] * yy
                                             + freq[k, 1] * xx + phase[k])
        img += rng.rand(h, w, 3).astype(np.float32) * 0.15
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            path, quality=90)

    per = EVAL_DB // EVAL_Q
    imlist, db_paths = [], []
    for i in range(EVAL_DB):
        name = "db%02d" % i
        db_paths.append(os.path.join(jpg, name + ".jpg"))
        photo(i // per, *EVAL_SHAPES[i % len(EVAL_SHAPES)], db_paths[-1])
        imlist.append(name)
    qimlist, gnd = [], []
    for q in range(EVAL_Q):
        h, w = EVAL_SHAPES[(q + 3) % len(EVAL_SHAPES)]
        photo(q, h, w, os.path.join(jpg, "q%d.jpg" % q))
        qimlist.append("q%d" % q)
        own = list(range(q * per, (q + 1) * per))
        gnd.append({"easy": np.asarray(own[:4]), "hard": np.asarray(own[4:7]),
                    "junk": np.asarray(own[7:]),
                    "bbx": [w // 10, h // 8, w - w // 10, h - h // 8]})
    with open(os.path.join(root, "roxford5k", "gnd_roxford5k.pkl"),
              "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd}, f)
    return db_paths


def eval_params(root, lw_path, shape_bucket):
    """EVAL with the seeded Lw, the synthetic set and `shape_bucket`."""
    import copy
    params = copy.deepcopy(EVAL)
    params["network"]["runtime"]["wrappers"]["eval"]["0_cirwhiten"][
        "whitening"] = lw_path
    params["data"]["shape_bucket"] = shape_bucket
    params["validation"] = {"dir_main": root, "datasets": ["roxford5k"]}
    return params


def _recorded(stage, run):
    """run() while `stage.evaluate_dataset` records what it returns:
    (run's result, [(metrics, aps, vecs, qvecs)])."""
    records, original = [], stage.evaluate_dataset

    def recording(*args, **kwargs):
        records.append(original(*args, **kwargs))
        return records[-1]

    stage.evaluate_dataset = recording
    try:
        return run(), records
    finally:
        stage.evaluate_dataset = original


def eval_breakdown(params, paths, want):
    """Per image, through the validate stage's own set-up: the host's load
    (decode, LANCZOS; one thread); the host's enqueue, the time the
    extractor call that validate makes (pad, upload, the whole chain) takes
    to return with the card idle before it (nothing inside synchronises);
    and the device's parts by CUDA events, on a copy of that chain with an
    event between the parts (upload; preprocess with K4; each scale's
    resize + VGG16 + GeM; aggregation + Lw; the gaps the host leaves are
    inside them). Both chains' descriptors must equal `want` (D, N), the
    validate run's."""
    from gandtr_tpu_torch.eval import retrieval as R
    from gandtr_tpu_torch.ops.maskprop import MaskState, mask_from_sizes
    from gandtr_tpu_torch.ops.resize import masked_scale_resize
    from gandtr_tpu_torch.scenarios import validate_stage
    setup = validate_stage.build_eval(params, torch.device("cuda"))
    ex, model = setup["extractor"], setup["model"]
    lw, ms = model.wrappers_eval          # sorted: 0_cirwhiten, 1_...
    size = params["data"]["image_size"]
    t0 = time.perf_counter()
    loaded = [R._load_preprocessed(p, size, setup["transform"])
              for p in paths]
    host_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    enqueue, direct = [], []
    for rep in range(2):                  # the first pass warms up
        for img in loaded:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = ex(img)
            t1 = time.perf_counter()
            if rep:
                enqueue.append(t1 - t0)
                direct.append(v)
    torch.cuda.synchronize()
    host = [ex._pad_and_mask(img) for img in loaded]
    names = (["upload", "preprocess"]
             + ["scale_%.4g" % s for s in ms.scales] + ["aggregate_lw"])
    marks, got = [], []
    with torch.inference_mode():
        for rep in range(2):              # the first pass warms up
            marks = []
            for padded, hw in host:
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(len(names) + 1)]
                ev[0].record()
                x = ex._upload(padded[None])
                sizes = ex._upload(np.asarray([hw], np.int64))
                mask = mask_from_sizes((sizes[:, 0], sizes[:, 1]),
                                       x.shape[1], x.shape[2])
                ev[1].record()
                y = setup["pre"](x, mask)
                ev[2].record()
                st = MaskState.maybe(mask, [hw])
                descs = []
                for k, s in enumerate(ms.scales):
                    xs, sts = (y, st) if s == 1 else \
                        masked_scale_resize(y, st, s)
                    descs.append(model.module(
                        xs, mask=sts.mask(xs.shape[1], xs.shape[2])))
                    ev[3 + k].record()
                v = lw.post(ms.post(descs, setup["ctx"], None),
                            setup["ctx"], None)
                ev[-1].record()
                marks.append(ev)
                if rep:
                    got.append(v[0])
        torch.cuda.synchronize()
    parts = {n: float(np.mean([ev[i].elapsed_time(ev[i + 1])
                               for ev in marks]))
             for i, n in enumerate(names)}
    d = max(float(np.abs(torch.stack(g, 1).cpu().numpy() - want).max())
            for g in (got, direct))
    return {"host_load_ms_per_image": host_ms,
            "host_enqueue_ms_per_image": 1e3 * float(np.mean(enqueue)),
            "device_ms_per_image": sum(parts.values()),
            "device_parts_ms_per_image": parts, "vs_validate_max": d}


def eval_busy_share(params):
    """The device's busy share over the evaluation of the dataset in one
    bucketed validate run (`evaluate_dataset`: loading, extraction, ranking
    and mAP; the stage's set-up before it is left out): the kernels' and
    copies' time on the card (torch.profiler, CUDA activity only) over that
    window's wall time; and the host's time inside the extractor calls
    there (pad, upload, the chain's launches), with the loader threads
    running beside them."""
    from torch.profiler import ProfilerActivity, profile
    from gandtr_tpu_torch.eval.retrieval import ShapeCachedExtractor
    from gandtr_tpu_torch.scenarios import validate_stage
    window, in_calls = {}, []
    original = validate_stage.evaluate_dataset
    call = ShapeCachedExtractor.__call__

    def timed_call(self, img):
        t0 = time.perf_counter()
        out = call(self, img)
        in_calls.append(time.perf_counter() - t0)
        return out

    def profiled(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = original(*args, **kwargs)
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - t0
        window["prof"] = prof
        return res

    validate_stage.evaluate_dataset = profiled
    ShapeCachedExtractor.__call__ = timed_call
    try:
        validate_stage.validate(params, None)
    finally:
        validate_stage.evaluate_dataset = original
        ShapeCachedExtractor.__call__ = call
    wall = window["wall"]
    busy_us = sum(e.time_range.elapsed_us() for e in window["prof"].events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    share = busy_us / 1e6 / wall
    call_ms = 1e3 * float(np.mean(in_calls))
    print("eval bucketed, the dataset's evaluation under the profiler (set-"
          "up left out): %.3f s wall, the card busy %.3f s (%.1f%%), idle "
          "%.1f%%; the host %.2f ms a photo in the extractor's call (%d "
          "calls)" % (wall, busy_us / 1e6, 100 * share, 100 - 100 * share,
                      call_ms, len(in_calls)))
    return {"wall_s": wall, "busy_s": busy_us / 1e6, "busy_share": share,
            "host_ms_in_extractor_call": call_ms}


def check_ranking(vecs, qvecs):
    """rank_descriptors on the card against numpy's stable argsort of the
    float64 scores: equal wherever a rank's score is more than 1e-6 from
    its neighbours'. Returns (positions compared, positions excluded, rank
    ms)."""
    from gandtr_tpu_torch.ops.ranking import (compute_map_protocols,
                                              rank_descriptors)
    V = torch.from_numpy(vecs).cuda()
    Q = torch.from_numpy(qvecs).cuda()
    ranks = rank_descriptors(V, Q).cpu().numpy()
    s64 = vecs.T.astype(np.float64) @ qvecs.astype(np.float64)
    want = np.argsort(-s64, axis=0, kind="stable")
    srt = np.take_along_axis(s64, want, axis=0)
    gap = np.abs(np.diff(srt, axis=0)) > 1e-6
    clear = np.ones(srt.shape, bool)
    clear[1:] &= gap
    clear[:-1] &= gap
    wrong = int(((ranks != want) & clear).sum())
    print("ranking on the card vs float64 numpy: %d of %d positions "
          "compared, %d excluded (a neighbour within 1e-6), %d differ"
          % (int(clear.sum()), clear.size, int((~clear).sum()), wrong))
    if wrong:
        raise AssertionError("rank_descriptors differs from numpy")
    rank_ms = cuda_ms(lambda: rank_descriptors(V, Q), reps=20)
    return int(clear.sum()), int((~clear).sum()), rank_ms


def run_eval(dev):
    """The validate stage of eval.yml on the card, bucketed (K4) and exact
    (K1): each mode runs once to warm up, then once with every launch count
    set to 0 just before it. Checks the descriptors, the launches, the mAPs,
    the ranking, and two images against the port on the CPU."""
    import pickle
    import shutil
    import tempfile
    from gandtr_tpu_torch.eval import retrieval as R
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import clahe_masked as kmasked
    from gandtr_tpu_torch.ops.ranking import compute_map_protocols
    from gandtr_tpu_torch.scenarios import validate_stage
    calls = {"K4": [], "K1": []}
    root = tempfile.mkdtemp(prefix="eval_set_")
    try:
        t0 = time.perf_counter()
        db_paths = make_eval_set(root)
        lw_path = os.path.join(root, "lw.pkl")
        with open(lw_path, "wb") as f:
            pickle.dump(seeded_lw(), f)
        print("eval set: %d database photos, %d queries, written in %.1f s"
              % (EVAL_DB, EVAL_Q, time.perf_counter() - t0))
        n_img = EVAL_DB + EVAL_Q
        out = {}
        for bucket in (64, None):
            mode = "bucketed" if bucket else "exact"
            params = eval_params(root, lw_path, bucket)
            t0 = time.perf_counter()
            validate_stage.validate(params, None)
            cold = time.perf_counter() - t0
            torch.cuda.synchronize()
            kernel, other = ("K4", "K1") if bucket else ("K1", "K4")
            restore = (_recording_calls(kmasked, "clahe_u8_masked_cuda",
                                        calls["K4"]) if bucket else
                       _recording_calls(kclahe, "clahe_u8_cuda", calls["K1"]))
            try:
                reset_launches()
                t0 = time.perf_counter()
                (res,), rec = _recorded(validate_stage, lambda: validate_stage
                                        .validate(params, None))
                wall = time.perf_counter() - t0
                counts = launches()
            finally:
                restore()
            # the stage's set-up alone (the net with its seeded weights
            # drawn on the host, the Lw): the rest of the wall is the
            # extraction, ranking and mAP
            t0 = time.perf_counter()
            validate_stage.build_eval(params, dev)
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            metrics, aps, vecs, qvecs = rec[0]
            out[mode] = {"wall_s": wall, "first_wall_s": cold,
                         "setup_s": setup, "images_per_s": n_img / wall,
                         "images_per_s_after_setup": n_img / (wall - setup),
                         "launches": counts,
                         "metadata": res["metadata"]["validation"],
                         "aps": aps, "vecs": vecs, "qvecs": qvecs}
            print("eval %s (shape_bucket %s): %.3f s for %d images, %.2f "
                  "images/s (first run %.3f s); set-up %.3f s, after it "
                  "%.2f images/s; launches %s; mAP %s"
                  % (mode, bucket, wall, n_img, n_img / wall, cold, setup,
                     n_img / (wall - setup), counts,
                     json.dumps({k: v for k, v in metrics.items()})))
            for name, v in (("vecs", vecs), ("qvecs", qvecs)):
                norms = np.linalg.norm(v, axis=0)
                if not np.isfinite(v).all() or v.shape[0] != 512 \
                        or np.abs(norms - 1).max() > 1e-5:
                    raise AssertionError("%s %s: bad %s %s" % (
                        mode, name, v.shape, norms))
            # eval.yml has no loader section: batch size 1, one batch an
            # image
            if counts[kernel] != n_img or counts[other] != 0:
                raise AssertionError("%s eval launched %s for %d batches"
                                     % (mode, counts, n_img))
        geo = check_clahe_at_eval(calls)
        busy = eval_busy_share(eval_params(root, lw_path, 64))
        b, e = out["bucketed"], out["exact"]
        d_be = float(max(np.abs(b["vecs"] - e["vecs"]).max(),
                         np.abs(b["qvecs"] - e["qvecs"]).max()))
        # the two modes' ranks, and the per-query APs where they agree
        from gandtr_tpu_torch.ops.ranking import rank_descriptors
        rb, re_ = (rank_descriptors(o["vecs"], o["qvecs"]).cpu().numpy()
                   for o in (b, e))
        same_q = [q for q in range(EVAL_Q)
                  if np.array_equal(rb[:, q], re_[:, q])]
        ap_diff = max([abs(b["aps"][k][q] - e["aps"][k][q])
                       for k in b["aps"] for q in same_q] or [0.0])
        print("eval bucketed vs exact: descriptors max |diff| %.3g; ranks "
              "equal for %d of %d queries, their APs max |diff| %.3g; "
              "metadata %s vs %s" % (d_be, len(same_q), EVAL_Q, ap_diff,
                                     json.dumps(b["metadata"]),
                                     json.dumps(e["metadata"])))
        if d_be > 1e-4 or ap_diff:
            raise AssertionError("bucketed and exact eval disagree")
        if len(same_q) == EVAL_Q and any(
                b["metadata"][k] != e["metadata"][k]
                for k in b["metadata"] if "score_avg" in k):
            raise AssertionError("equal ranks, different mAPs")
        compared, excluded, rank_ms = check_ranking(
            b["vecs"], np.concatenate([b["qvecs"], b["vecs"]], axis=1))
        ranks = rank_descriptors(b["vecs"], b["qvecs"]).cpu().numpy()
        cfg = R.configdataset("roxford5k", root)
        t0 = time.perf_counter()
        for _ in range(20):
            compute_map_protocols("roxford5k", ranks, cfg["gnd"])
        map_ms = 1e3 * (time.perf_counter() - t0) / 20

        # two database images through the port on the CPU
        torch.set_num_threads(os.cpu_count() or 1)
        cpu = validate_stage.build_eval(eval_params(root, lw_path, 64),
                                        torch.device("cpu"))
        t0 = time.perf_counter()
        cpu_vecs = R.extract_vectors(cpu["extractor"], db_paths[:2], 1024,
                                     cpu["transform"])
        cpu_s = time.perf_counter() - t0
        d_cpu = float(np.abs(cpu_vecs - b["vecs"][:, :2]).max())
        print("eval card vs CPU port on 2 database images: max |diff| %.3g "
              "(CPU took %.1f s)" % (d_cpu, cpu_s))
        if d_cpu > 1e-4:
            raise AssertionError("eval card vs CPU port: %g" % d_cpu)

        bd = eval_breakdown(eval_params(root, lw_path, 64), db_paths,
                            b["vecs"])
        print("eval breakdown (bucketed, per database image): host load "
              "%.2f ms, host enqueue %.2f ms, against device %.2f ms: %s; "
              "ranking %.4f ms (%d x %d), mAP %.3f ms (host)"
              % (bd["host_load_ms_per_image"],
                 bd["host_enqueue_ms_per_image"], bd["device_ms_per_image"],
                 json.dumps(bd["device_parts_ms_per_image"]), rank_ms,
                 EVAL_DB, EVAL_Q + EVAL_DB, map_ms))
        if bd["vs_validate_max"] > 1e-5:
            raise AssertionError("the breakdown's chain differs from "
                                 "validate's: %g" % bd["vs_validate_max"])
        return {"launches": {m: out[m]["launches"] for m in out},
                "images_per_s": {m: out[m]["images_per_s"] for m in out},
                "images_per_s_after_setup": {
                    m: out[m]["images_per_s_after_setup"] for m in out},
                "setup_s": {m: out[m]["setup_s"] for m in out},
                "bucketed_device_busy": busy,
                "bucketed_vs_exact": d_be, "card_vs_cpu": d_cpu,
                "ranks_compared": compared, "ranks_excluded": excluded,
                "rank_ms": rank_ms, "map_ms": map_ms, "breakdown": bd,
                "at_eval_geometry": geo}
    finally:
        shutil.rmtree(root, ignore_errors=True)


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

    # ---- the fine-tune loop of finetune.yml
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop = run_finetune_loop(dev, ft["ms_per_step"])

    # ---- the retrieval eval of eval.yml
    torch.cuda.empty_cache()
    ev = run_eval(dev)
    print("eval summary: %s" % json.dumps(
        {k: v for k, v in ev.items()
         if k not in ("breakdown", "at_eval_geometry")}))
    by_path = {k: {"serve": desc_launches[k] + gen_launches[k],
                   "finetune": ft["launches"][k],
                   "finetune_loop": loop["launches"][k],
                   "eval": sum(c[k] for c in ev["launches"].values())}
               for k in ("K1", "K2", "K3", "K4")}

    print(json.dumps({"kernels": [{
        "name": "clahe_u8 (K1: static CLAHE, LUTs + interpolation in one "
                "kernel)",
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/clahe.cu",
        "replaces": "gandtr_tpu/ops/clahe_pallas.py:62",
        "launches": sum(by_path["K1"].values()),
        "launches_by_path": by_path["K1"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "at_eval_geometry": ev["at_eval_geometry"]["K1"],
    }, {
        "name": "fused_resblock (K3: conv3x3 + IN + ReLU + conv3x3 + IN + x)",
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/resblock.cu",
        "replaces": "gandtr_tpu/ops/resblock_pallas.py:109",
        "launches": sum(by_path["K3"].values()),
        "launches_by_path": by_path["K3"],
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
        "launches": sum(by_path["K2"].values()),
        "launches_by_path": by_path["K2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": ("clahe_u8_masked (K4: masked CLAHE, LUT build + "
                 "interpolation in one kernel)"),
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/clahe.cu",
        "replaces": "gandtr_tpu/ops/clahe_pallas.py:289",
        "launches": sum(by_path["K4"].values()),
        "launches_by_path": by_path["K4"],
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "at_eval_geometry": ev["at_eval_geometry"]["K4"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
