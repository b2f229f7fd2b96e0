"""Where the HED^N-GAN step's convolutions lose time on the card: the port's
HED forward (its convs on channels-last views, as every layer of the port
runs them) against the same forward on contiguous NCHW tensors, and each
distinct conv shape of it alone in both layouts, float32 with TF32 off
(the port's policy: deterministic cuDNN algorithms chosen by heuristics),
then with cuDNN timing its candidates (`benchmark`): deterministic ones in
both layouts, and any in NCHW. Prints one JSON line: ms (CUDA events,
median of 3 windows of 5 calls) and achieved TFLOP/s. Run on a GPU
machine:

    python3 scripts/torch_gan_layout_probe.py
"""
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH, SIDE = 10, 256


def cuda_ms(fn, reps=5, runs=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def hed_nchw(hed, x):
    """HED's forward on contiguous NCHW tensors with the module's weights."""
    H, W = x.shape[2:]
    scores = []
    h = x
    for b in range(1, 6):
        for layer in getattr(hed, "vgg%d" % b):
            if isinstance(layer, torch.nn.Conv2d):
                h = F.conv2d(h, layer.weight, layer.bias, padding=layer.pad)
            elif isinstance(layer, torch.nn.ReLU):
                h = F.relu(h)
            else:
                h = F.max_pool2d(h, 2, 2)
        s = getattr(hed, "score%d" % b)
        s = F.conv2d(h, s.weight, s.bias)
        scores.append(s if s.shape[2:] == (H, W) else F.interpolate(
            s, size=(H, W), mode="bilinear", align_corners=False))
    f = hed.fusion[0]
    return F.conv2d(torch.cat(scores, 1), f.weight, f.bias)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from gandtr_tpu_torch.device import resolve_device
    from gandtr_tpu_torch.hub import _init_random
    from gandtr_tpu_torch.models.hed import HedInterpolation
    dev = resolve_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    hed = _init_random(HedInterpolation()).to(dev)
    x = torch.randn(BATCH, SIDE, SIDE, 3, device=dev)
    xc = x.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        gap = float((hed(x, no_sigmoid=True).permute(0, 3, 1, 2)
                     - hed_nchw(hed, xc)).abs().max())
        out = {"card": card, "batch": BATCH, "side": SIDE,
               "forward_nhwc_vs_nchw_max": gap,
               "hed_forward_ms": {
                   "channels_last_views": cuda_ms(
                       lambda: hed(x, no_sigmoid=True)),
                   "nchw": cuda_ms(lambda: hed_nchw(hed, xc))}}
        convs, side, c = [], SIDE, 3
        for b, widths in enumerate(((64, 64), (128, 128), (256,) * 3,
                                    (512,) * 3, (512,) * 3), start=1):
            side = side if b == 1 else side // 2
            for w in widths:
                convs.append((c, w, side))
                c = w
        rows = []
        for cin, cout, s in sorted(set(convs)):
            a = torch.randn(BATCH, cin, s, s, device=dev)
            a_cl = a.contiguous(memory_format=torch.channels_last)
            wt = torch.randn(cout, cin, 3, 3, device=dev) * 0.05
            flop = 2.0 * BATCH * s * s * cout * cin * 9
            ms = {"nchw": cuda_ms(lambda: F.conv2d(a, wt, padding=1)),
                  "channels_last": cuda_ms(
                      lambda: F.conv2d(a_cl, wt, padding=1))}
            # cuDNN's own choice by timing (outside the port's policy of
            # algorithms by heuristics): among deterministic ones, and any
            torch.backends.cudnn.benchmark = True
            for layout, t in (("nchw", a), ("channels_last", a_cl)):
                ms[layout + "_benchmarked_deterministic"] = cuda_ms(
                    lambda: F.conv2d(t, wt, padding=1))
            torch.backends.cudnn.deterministic = False
            ms["nchw_benchmarked_any"] = cuda_ms(
                lambda: F.conv2d(a, wt, padding=1))
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            rows.append({"cin": cin, "cout": cout, "side": s,
                         "count": convs.count((cin, cout, s)),
                         "ms": ms, "tflop_s": {k: flop / v / 1e9
                                               for k, v in ms.items()}})
        out["convs"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
