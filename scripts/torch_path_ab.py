"""Time the port's conv paths of this checkout against another tree's, on
one GPU: the served generator (K3) and the fine-tune tuple step (K2).

    python3 scripts/torch_path_ab.py OTHER_ROOT [--rounds 2]

OTHER_ROOT is the root of another checkout, e.g. a parent commit unpacked
with `git archive` into a directory that .gitignore lists. Each round runs
each tree in a fresh process (the other tree first in even rounds), which
builds that tree's kernels and measures, through that tree's own package:

- the served generator (hub `cyclegan`, seeded weights, bf16, a batch of 8
  at 768x1024): the direct `Servable` call by host clock (median of 3 after
  a warm-up) and the nine residual blocks by CUDA events (median of 3
  windows of 3 calls);
- the fine-tune step: the tree's `chip_smoke.run_finetune` (2 warm-up and 5
  timed steps, host clock, with its own launch and update checks).

Prints the card's name and power limit, each run's numbers, and each tree's
medians over the rounds.
"""
import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

CHILD = r'''
import contextlib, io, json, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as c
from gandtr_tpu_torch import hub
from gandtr_tpu_torch.serving.export import Servable
with contextlib.redirect_stdout(io.StringIO()):
    c.build_all()
dev = torch.device("cuda")
out = {}
gen = hub.cyclegan(pretrained=False)
gen.net.compute_dtype = torch.bfloat16
images = np.random.RandomState(2).randint(0, 256, (c.N_REQ,) + c.HW + (3,),
                                          dtype=np.uint8)
sv = Servable(gen, c.HW)
sv(images)
walls = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sv(images)
    walls.append(1e3 * (time.perf_counter() - t0))
out["direct_ms"] = float(np.median(walls))
seq = gen.net.compute_module().model
blocks = [i for i, m in enumerate(seq) if type(m).__name__ == "ResnetBlock"]
with torch.inference_mode():
    x = torch.randn((c.N_REQ,) + c.HW + (3,), device=dev).to(torch.bfloat16)
    h = seq[:blocks[0]](x)
    body = seq[blocks[0]:blocks[-1] + 1]
    body(h)
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            body(h)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 3)
out["nine_blocks_ms"] = float(np.median(times))
del gen, sv, seq, body, h, x
torch.cuda.empty_cache()
with contextlib.redirect_stdout(io.StringIO()):
    _, _, ft = c.run_finetune(dev)
out["step_ms"] = ft["ms_per_step"]
print("PATH_AB " + json.dumps(out))
'''


def _run(root):
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=str(root),
                          capture_output=True, text=True, timeout=900)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("PATH_AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError("%s failed (rc %d):\n%s" % (
            root, proc.returncode, (proc.stdout + proc.stderr)[-4000:]))
    return json.loads(lines[-1][len("PATH_AB "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("torch_path_ab: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    trees = {"this": ROOT, "other": pathlib.Path(opts.other).resolve()}
    runs = {"this": [], "other": []}
    for r in range(opts.rounds):
        for tag in (("other", "this") if r % 2 == 0 else ("this", "other")):
            res = _run(trees[tag])
            runs[tag].append(res)
            print("round %d %s: %s" % (r, tag, json.dumps(res)), flush=True)
    for tag, rs in runs.items():
        print("%s medians: %s" % (tag, json.dumps(
            {k: float(np.median([x[k] for x in rs])) for k in rs[0]})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
