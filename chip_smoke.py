"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA source of the port (gandtr_tpu_torch/csrc/*.cu, one
   nvcc each, all at once) into the ignored gandtr_tpu_torch/_build/.
3. K1 (static CLAHE) against its plain PyTorch version on the card:
   bit-equal on a batch of 8 at 768x1024, a 29x35 and a 362x500 image, at
   grids 8 and 4; kernel and plain medians by CUDA events.
4. K3 (the fused ResNet block) against its plain version and the float32
   block, at the served block shape (8, 192, 256, 256) and at (2, 17, 23,
   64): within max 0.06 and mean 0.01, and two launches bit-equal; K3,
   plain and library (cuDNN bf16 convs + torch instance norm) medians.
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
7. Stage breakdowns of one batch of each path, the `{"kernels": [...]}`
   line, the card's line again, and last `{"ok": true, "device": {...}}`.

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


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of `fn()` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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
            if ("registers" in line or "spill" in line
                    or "error" in line.lower()):
                print("  " + line.strip())
    print("build: %d sources in %.1f s" % (len(names), secs))
    return names


def reset_launches():
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import resblock as kres
    kclahe.LAUNCHES = 0
    kres.LAUNCHES = 0


def launches():
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.kernels import resblock as kres
    return {"K1": kclahe.LAUNCHES, "K3": kres.LAUNCHES}


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
        print("K3 at %s: kernel %.3f ms (%.1f TFLOP/s), plain %.3f ms, "
              "library %.3f ms, bound %.4f ms (%s)"
              % (shape, out["ms"], out["tflop_s"], out["plain_ms"],
                 out["library_ms"], out["bound_ms"], out["bound_by"]))
        del xl, lw1, lw2
    del x, w1, w2, b1, b2, args, got, again
    torch.cuda.empty_cache()
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
    build_all()
    dev = torch.device("cuda")
    k1 = check_k1(dev)

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
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
