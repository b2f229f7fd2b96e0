"""The HED^N-GAN student's E-step gradient against float64, whole and layer
by layer, on the card and on the CPU, at the state that chip_smoke.py's
concat_student check reads: train_hedngan.yml's nets at full width with
seeded weights, OPT_DRIFT separate steps at batch 10 and 256x256 on the
card, then the E step's pieces at batch 2 and 128x128.

    python3 scripts/torch_e_grad_layers.py --out DIR

Needs a CUDA card. Each float32 variant of the E gradient is held against
the same pieces in float64 on the CPU:

- `cpu`: the port on the CPU;
- `card`: the port on the card (cuDNN under the port's float32 policy);
- `card_native`: the card with cuDNN off (PyTorch's own CUDA convolutions);
- `cpu_fake64`, `card_fake64`: the student fed the float64 run's fake_Y,
  which leaves the generator's error out;
- `cpu_gates64`, `card_gates64`, `card_native_gates64`: the student routed
  by float64's gates (each ReLU's on/off, each max-pool's argmax), which
  leaves out the gradient's jumps where float32 lands a gate the other
  way.

For each: the distance of the whole gradient and of its E_real and E_fake
parts (|g - g64| / |g64|), and of each parameter's; the elements of
real_M - target_M and fake_M - target_M whose sign differs from float64's;
the student's gates that differ from float64's; and the gradient backpropagated from float64's L1 signs (the backward
alone). The step's own E gradient (chip_smoke's reading) is printed for
`cpu` and `card` beside them.

Layer by layer, each convolution of the student (on the real image) and of
the generator is fed the float64 run's input, and the student's also its
output gradient, in float32: the distance of the output, of the input
gradient and of the weight gradient from float64's, on the CPU and on the
card with cuDNN and without.

Last, a child process runs each of the student's convolutions once forward
and backward at these shapes under cuDNN's API log; the engines cuDNN
reports for each are printed, and the log is kept as DIR/cudnn.log.

Prints the card's name and power limit first and writes everything to
DIR/e_grad_layers.json.
"""
import argparse
import copy
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from gandtr_tpu_torch.models.layers import Conv, ConvTranspose  # noqa: E402
from gandtr_tpu_torch.ops import losses as L  # noqa: E402
from gandtr_tpu_torch.scenarios.build import build_gan_experiment  # noqa

POLICY = dict(deterministic=True, allow_tf32=False, benchmark=False)


def rel(a, b):
    b = b.double().cpu()
    return float((a.double().cpu() - b).norm() / b.norm())


def drifted(dev, root, batch, hw):
    """(cfg without data, the nets' state after OPT_DRIFT steps on `dev`)."""
    lists = c.make_domain_set(root)
    cfg = c.gan_train_config(root, lists)
    cfg.pop("data")
    exp = build_gan_experiment(cfg, device=dev)
    for X, Y in c._seeded_gan_batches(c.OPT_DRIFT + 1, batch, hw,
                                      11)[:c.OPT_DRIFT]:
        exp["step"](exp["state"], torch.from_numpy(X).to(dev),
                    torch.from_numpy(Y).to(dev))
    snap = c._gan_snapshot(exp)
    del exp
    torch.cuda.empty_cache()
    return cfg, snap


def convs(module):
    return {n: m for n, m in module.named_modules()
            if isinstance(m, (Conv, ConvTranspose))}


def e_pieces(cfg, snap, where, dtype, X, fake_in=None, signs=None,
             record=None, force_gates=None):
    """The E step's pieces as build_hedngan_step computes them (separate
    forwards): metrics, the E_real and E_fake gradients by parameter, the
    gradient backpropagated from `signs` (float64's) where given, and the
    student's gates (each ReLU's output > 0, each max-pool's argmax) on
    both images; with `force_gates` (float64's), the student routes by
    those. With `record`, the float64 run's conv inputs and output
    gradients go there."""
    exp = build_gan_experiment(cfg, device=where)
    c._gan_load(exp, snap)
    if dtype == torch.float64:
        for net in exp["models"].values():
            net.module.double()
    m = exp["models"]
    G, Hs, Ht = m["generator_X"], m["detector"], m["detector_frozen"]
    w_hed = float(cfg["learning"]["training"]["criterion"]["weights"]
                  .get("hed", 1.0))
    handles = []

    def watch(net, tag, with_grad):
        for name, mod in convs(net).items():
            key = "%s.%s" % (tag, name)

            def hook(mod, inp, out, key=key):
                if key in record:
                    return
                record[key] = {"x": inp[0].detach().cpu(), "mod": mod}
                if with_grad:
                    out.register_hook(lambda g, key=key: record[key]
                                      .__setitem__("go", g.cpu()))
            handles.append(mod.register_forward_hook(hook))
    if record is not None:
        watch(G.module, "G", False)
    x = torch.from_numpy(X).to(where, dtype)
    if fake_in is None:
        with torch.no_grad():
            fake = G.apply(x, train=True)
    else:
        fake = fake_in.to(where, dtype)
    with torch.no_grad():
        target = Ht.apply(x, train=False, no_sigmoid=True)
    for h in handles:
        h.remove()
    if record is not None:
        watch(Hs.module, "E", True)
    gate = {}
    handles += c.student_gates(Hs.module, gate, force_gates)
    real_M = Hs.apply(x, train=False, no_sigmoid=True)
    fake_M = Hs.apply(fake, train=False, no_sigmoid=True)
    for h in handles:
        h.remove()
    e_real = w_hed * L.l1_loss(real_M, target)
    e_fake = w_hed * L.l1_loss(fake_M, target)
    names, params = zip(*Hs.module.named_parameters())
    g_real = torch.autograd.grad(e_real, params, retain_graph=True)
    g_fake = torch.autograd.grad(e_fake, params, retain_graph=True)
    out = {"E_real": float(e_real.detach()),
           "E_fake": float(e_fake.detach()),
           "fake": fake.detach().cpu(), "target": target.cpu(),
           "real_M": real_M.detach().cpu(), "fake_M": fake_M.detach().cpu(),
           "g_real": {n: g.cpu() for n, g in zip(names, g_real)},
           "g_fake": {n: g.cpu() for n, g in zip(names, g_fake)},
           "gates": gate}
    if signs is not None:
        for part, M in (("real", real_M), ("fake", fake_M)):
            up = signs[part].to(where, dtype) * (w_hed / M.numel())
            g = torch.autograd.grad(M, params, up, retain_graph=True)
            out["g_%s_signs64" % part] = {n: t.cpu() for n, t in
                                          zip(names, g)}
    del exp
    return out


def compare(got, ref, ref_signs):
    flat = c._flat
    tot = {k: got["g_real"][k] + got["g_fake"][k] for k in got["g_real"]}
    tot64 = {k: ref["g_real"][k] + ref["g_fake"][k] for k in ref["g_real"]}
    res = {"E_real": got["E_real"], "E_fake": got["E_fake"],
           "grad": rel(flat(tot), flat(tot64)),
           "grad_real": rel(flat(got["g_real"]), flat(ref["g_real"])),
           "grad_fake": rel(flat(got["g_fake"]), flat(ref["g_fake"])),
           "fake_Y": rel(got["fake"], ref["fake"]),
           "target_M": rel(got["target"], ref["target"]),
           "real_M": rel(got["real_M"], ref["real_M"]),
           "fake_M": rel(got["fake_M"], ref["fake_M"])}
    for part, M in (("real", "real_M"), ("fake", "fake_M")):
        s = torch.sign(got[M].double() - got["target"].double())
        res["sign_flips_" + part] = int((s != ref_signs[part]).sum())
        if "g_%s_signs64" % part in got:
            res["grad_%s_from_signs64" % part] = rel(
                flat(got["g_%s_signs64" % part]), flat(ref["g_" + part]))
    res["gate_flips"] = {k: int((v != ref["gates"][k]).sum())
                         for k, v in got["gates"].items()}
    res["by_param"] = {k: rel(tot[k], tot64[k]) for k in sorted(tot)}
    return res


def step_grad(cfg, snap, where, X, Y):
    """The step's own E gradient (chip_smoke's reading), float32."""
    e = build_gan_experiment(cfg, device=where)
    c._gan_load(e, snap)
    got = c._grab_grads(e, ("detector",))
    e["step"](e["state"], torch.from_numpy(X).to(where),
              torch.from_numpy(Y).to(where))
    del e
    return c._flat(got["detector"]).double()


def local(rec, where, native=False):
    """Each recorded conv in float32 on `where`, fed float64's input (and
    output gradient): distances of y, dx and dw from float64's."""
    out = {}
    for key, r in rec.items():
        mod64, x64 = r["mod"], r["x"]
        go64 = r.get("go")
        if "y64" not in r:
            xr = x64.clone().requires_grad_(go64 is not None)
            r["y64"] = mod64(xr)
            if go64 is not None:
                r["gx64"], r["gw64"] = torch.autograd.grad(
                    r["y64"], (xr, mod64.weight), go64)
            r["y64"] = r["y64"].detach()
        y64, gx64, gw64 = r["y64"], r.get("gx64"), r.get("gw64")
        row = {"shape": list(x64.shape), "weight": list(mod64.weight.shape)}
        mod = copy.deepcopy(mod64).float().to(where)
        x = x64.float().to(where).requires_grad_(go64 is not None)
        with torch.backends.cudnn.flags(enabled=not native, **POLICY):
            y = mod(x)
            row["y"] = rel(y.detach(), y64)
            if go64 is not None:
                gx, gw = torch.autograd.grad(y, (x, mod.weight),
                                             go64.float().to(where))
                row["dx"] = rel(gx, gx64)
                row["dw"] = rel(gw, gw64)
        out[key] = row
    return out


CHILD = r'''
import json, sys, torch
import torch.nn.functional as F
sys.path.insert(0, ".")
from gandtr_tpu_torch.device import set_float32_policy
set_float32_policy()
for key, xs, ws, pad in json.loads(sys.argv[1]):
    x = torch.randn(xs, device="cuda").requires_grad_(True)
    w = torch.randn(ws, device="cuda").requires_grad_(True)
    torch.cuda.synchronize()
    print("=== CONV %s x%s w%s fwd+bwd" % (key, xs, ws), file=sys.stderr,
          flush=True)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, 1, pad)
    y.permute(0, 2, 3, 1).sum().backward()
    torch.cuda.synchronize()
    print("=== END %s" % key, file=sys.stderr, flush=True)
'''

ENGINE = re.compile(r"(eng\d+[\w=,:\-]*|globalIndex\s*[:=]\s*\d+|"
                    r"GLOBAL_INDEX\D{0,20}\d+|engineId\s*[:=]\s*\d+|"
                    r"CUDNN_BACKEND_OPERATION_CONVOLUTION_\w+)")


def cudnn_engines(rec, out_dir):
    """The child's cuDNN API log: {conv: [engine strings]}."""
    spec = []
    for key, r in rec.items():
        if key.startswith("E.") and r.get("go") is not None:
            mod = r["mod"]
            spec.append((key, list(r["x"].shape), list(mod.weight.shape),
                         mod.pad if isinstance(mod.pad, int) else 0))
    env = dict(os.environ, CUDNN_LOGLEVEL_DBG="3", CUDNN_LOGINFO_DBG="1",
               CUDNN_LOGDEST_DBG="stderr", CUDNN_FRONTEND_LOG_INFO="1",
               CUDNN_FRONTEND_LOG_FILE="stderr",
               TORCH_CUDNN_V8_API_DEBUG="1")
    log_path = os.path.join(out_dir, "cudnn.log")
    with open(log_path, "w") as f:
        proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(spec)],
                              cwd=str(ROOT), env=env, stderr=f,
                              stdout=subprocess.DEVNULL, timeout=600)
    text = open(log_path, errors="replace").read()
    if len(text) > 16 << 20:     # keep what comes back small
        with open(log_path, "w") as f:
            f.write(text[:16 << 20])
    found, cur = {}, None
    for line in text.splitlines():
        if line.startswith("=== CONV "):
            cur = line.split()[2]
            found[cur] = []
        elif line.startswith("=== END"):
            cur = None
        elif cur is not None:
            for hit in ENGINE.findall(line):
                if hit not in found[cur]:
                    found[cur].append(hit)
    return {"rc": proc.returncode, "log_bytes": len(text),
            "cudnn_version": torch.backends.cudnn.version(),
            "engines": found}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for e_grad_layers.json and cudnn.log")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    print(c.card_line(), flush=True)
    torch.set_num_threads(os.cpu_count() or 1)
    root = tempfile.mkdtemp(prefix="egrad_")
    try:
        run(torch.device("cuda"), root, args.out)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run(dev, root, out_dir, drift=(10, 256), hw=128):
    t0 = time.perf_counter()
    cfg, snap = drifted(dev, root, *drift)
    X, Y = c._seeded_gan_batches(1, 2, hw, 12)[0]

    rec = {}
    ref = e_pieces(cfg, snap, "cpu", torch.float64, X, record=rec)
    signs = {p: torch.sign(ref[M] - ref["target"])
             for p, M in (("real", "real_M"), ("fake", "fake_M"))}
    res = {"float64": {"E_real": ref["E_real"], "E_fake": ref["E_fake"],
                       "zero_diffs_real": int((signs["real"] == 0).sum()),
                       "elements": int(signs["real"].numel()),
                       "abs_diff_real_quantiles": [
                           float(q) for q in torch.quantile(
                               (ref["real_M"] - ref["target"]).abs()
                               .flatten(), torch.tensor(
                                   [0.001, 0.01, 0.1, 0.5],
                                   dtype=torch.float64))]}}
    g64 = ref["gates"]
    variants = {"cpu": ("cpu", None, False, None),
                "card": (dev, None, False, None),
                "card_native": (dev, None, True, None),
                "cpu_fake64": ("cpu", ref["fake"], False, None),
                "card_fake64": (dev, ref["fake"], False, None),
                "cpu_gates64": ("cpu", None, False, g64),
                "card_gates64": (dev, None, False, g64),
                "card_native_gates64": (dev, None, True, g64)}
    for name, (where, fake_in, native, force) in variants.items():
        with torch.backends.cudnn.flags(enabled=not native, **POLICY):
            got = e_pieces(cfg, snap, where, torch.float32, X,
                           fake_in=fake_in, signs=signs, force_gates=force)
        res[name] = compare(got, ref, signs)
        print(name, json.dumps({k: v for k, v in res[name].items()
                                if k != "by_param"}), flush=True)
    tot64 = c._flat({k: ref["g_real"][k] + ref["g_fake"][k]
                     for k in ref["g_real"]}).double()
    res["step"] = {w: rel(step_grad(cfg, snap, d, X, Y), tot64)
                   for w, d in (("cpu", "cpu"), ("card", dev))}
    print("step", json.dumps(res["step"]), flush=True)
    cols = ("cpu", "card", "card_native", "cpu_gates64", "card_gates64")
    print("by_param (%s):" % ", ".join(cols), flush=True)
    for k in res["cpu"]["by_param"]:
        print("  %-24s" % k + " ".join("%.3e" % res[v]["by_param"][k]
                                       for v in cols), flush=True)

    lay = {"cpu": local(rec, "cpu"), "card": local(rec, dev),
           "card_native": local(rec, dev, native=True)}
    res["layers"] = lay
    print("layers (y, dx, dw: cpu | card | card_native):", flush=True)
    for key in lay["cpu"]:
        cols = []
        for v in ("cpu", "card", "card_native"):
            r = lay[v][key]
            cols.append(" ".join("%.2e" % r[k] if k in r else "   -    "
                                 for k in ("y", "dx", "dw")))
        print("  %-22s %s | %s | %s" % (key, *cols), flush=True)

    if dev.type == "cuda":
        res["cudnn"] = cudnn_engines(rec, out_dir)
        print("cudnn", json.dumps(res["cudnn"]), flush=True)
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "e_grad_layers.json"), "w") as f:
        json.dump(res, f, indent=1)
    print("seconds", res["seconds"], flush=True)


if __name__ == "__main__":
    main()
