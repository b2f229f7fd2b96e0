"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA source of the port (gandtr_tpu_torch/csrc/*.cu, one
   nvcc each, all at once) into the ignored gandtr_tpu_torch/_build/.
3. K1 (static CLAHE) against its plain PyTorch version on the card:
   bit-equal on a batch of 8 at 768x1024, a 29x35 and a 362x500 image, at
   grids 8 and 4; kernel and plain medians by CUDA events.
4. The main path: the GeM-VGG16 hub model (seeded random weights, full
   width, multiscale, a seeded Lw) behind `serve_http` on 127.0.0.1,
   answering rounds of 8 concurrent npy `:predict` requests of 768x1024
   uint8 images. Every descriptor must be finite, of unit norm, equal to
   the direct `Servable` call, and (one image) agree with the port on the
   CPU within 1e-4. K1's launch count, set to 0 just before, must have
   risen.
5. Prints a stage breakdown of one batch, the `{"kernels": [...]}` line,
   the card's line again, and last `{"ok": true, "device": {...}}`.

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
            if "registers" in line or "error" in line.lower():
                print("  " + line.strip())
    print("build: %d sources in %.1f s" % (len(names), secs))
    return names


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


def _post_npy(url, img):
    buf = io.BytesIO()
    np.save(buf, img)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST",
                                 headers={"Content-Type":
                                          "application/octet-stream"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
    return np.asarray(body["descriptor"], np.float32), time.perf_counter() - t0


def seeded_lw(dim=512, seed=1):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(dim, dim))
    return {"P": q.astype(np.float32),
            "m": (rng.randn(dim, 1) * 0.01).astype(np.float32)}


def serve_main_path(model, images):
    """Rounds of N_REQ concurrent :predict requests; returns the served
    descriptors of the last round, and the timings."""
    from gandtr_tpu_torch.serving.export import Servable
    from gandtr_tpu_torch.serving.service import serve_http
    servable = Servable(model, HW)
    server = serve_http({"gem": servable}, port=0, block=False,
                        max_wait_ms=100.0)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        print("healthz:", health)
        if health["device"] != "cuda" or health["status"] != "ok":
            raise AssertionError("server is not on the card: %r" % health)
        url = base + "/v1/models/gem:predict"
        walls, lat, out = [], [], None
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
                raise RuntimeError("requests failed: %r" % errs)
            out = np.stack([r[0] for r in res])
            if rnd:  # round 0 warms cuDNN and the allocator
                walls.append(wall)
                lat += [r[1] for r in res]
        t0 = time.perf_counter()
        direct = servable(images)
        direct_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        server.close()
    return out, direct, {
        "images_per_s": N_REQ * ROUNDS / sum(walls),
        "ms_per_request": 1e3 * float(np.mean(lat)),
        "ms_per_round": 1e3 * float(np.median(walls)),
        "direct_servable_ms": direct_ms,
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
    """CUDA-event times of one batch of N_REQ through the served forward,
    stage by stage (after the main path, so warm)."""
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.serving.export import Servable

    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    build_all()
    dev = torch.device("cuda")
    k1 = check_k1(dev)

    lw = seeded_lw()
    model = hub.gem_vgg16_hedngan(pretrained=False, whitening=lw)
    images = np.random.RandomState(2).randint(
        0, 256, (N_REQ,) + HW + (3,), dtype=np.uint8)

    kclahe.LAUNCHES = 0
    served, direct, timing = serve_main_path(model, images)
    launches = kclahe.LAUNCHES
    print("main path: K1 launches %d for %d served images"
          % (launches, N_REQ * (ROUNDS + 1)))
    if launches < 1:
        raise AssertionError("the main path never launched K1")

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
    print("serving: %.3f images/s, %.2f ms per request, %.2f ms per round "
          "of %d; the direct Servable call on the same 8 took %.2f ms"
          % (timing["images_per_s"], timing["ms_per_request"],
             timing["ms_per_round"], N_REQ, timing["direct_servable_ms"]))
    breakdown = stage_breakdown(model, images)
    print("breakdown (batch %d at %dx%d): %s"
          % (N_REQ, HW[0], HW[1], json.dumps(breakdown)))

    print(json.dumps({"kernels": [{
        "name": "clahe_u8 (K1: LUT + interpolation)",
        "route": "cuda",
        "source": "gandtr_tpu_torch/csrc/clahe.cu",
        "replaces": "gandtr_tpu/ops/clahe_pallas.py:139",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "kernel_ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
