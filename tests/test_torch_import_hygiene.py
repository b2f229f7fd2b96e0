"""The port stands alone: no module of gandtr_tpu_torch imports jax, flax
or the JAX package, and its entry points refuse to fall back to the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "gandtr_tpu_torch"
FORBIDDEN = ("jax", "flax", "gandtr_tpu")
NEEDED = ("hub", "device", "ops.clahe", "ops.norm", "ops.resblock",
          "kernels.clahe", "kernels.resblock", "models.retrieval",
          "models.layers", "models.init", "models.generators",
          "learning.network", "data.transforms", "serving.export",
          "serving.service", "utils.weights", "ops.maskprop", "ops.vggconv",
          "ops.losses", "kernels.vggconv", "kernels.clahe_masked",
          "learning.criteria", "learning.optimizers", "learning.schedules",
          "learning.supervised", "data.cir_datasets",
          "scenarios.finetune_build", "utils.io", "data.datasets",
          "ops.ranking", "ops.resize", "eval.retrieval",
          "scenarios.infer_stage", "scenarios.validate_stage",
          "data.mining", "learning.events", "learning.checkpoints",
          "learning.training")

torch.set_num_threads(1)


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gandtr_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'gandtr_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'gandtr_tpu'))\n"
        "need = {'gandtr_tpu_torch.' + m for m in %r}\n"
        "print(len(names), bad, sorted(need - set(names)))\n"
        "sys.exit(1 if bad or need - set(names) else 0)\n" % (NEEDED,))
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_file_names_jax():
    """Also the imports inside functions, which the run above may not reach."""
    bad = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += ["%s: %s" % (path.name, n) for n in names if _forbidden(n)]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["hub", "serve_http", "cyclegan",
                                   "hedngan", "finetune", "validate"])
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from gandtr_tpu_torch import hub
    from gandtr_tpu_torch.scenarios.finetune_build import \
        build_finetune_experiment
    from gandtr_tpu_torch.scenarios.validate_stage import validate
    from gandtr_tpu_torch.serving.service import serve_http
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "hub":
            hub.gem_vgg16_hedngan(pretrained=False)
        elif entry == "serve_http":
            serve_http({}, block=False)
        elif entry == "finetune":
            build_finetune_experiment({"network": {}, "learning": {}})
        elif entry == "validate":
            validate({"network": {}, "validation": {}}, None)
        else:
            getattr(hub, entry)(pretrained=False)



def test_kernel_wrapper_takes_cuda_tensors_only():
    """The CPU path is chosen by the tensor's device in ops/clahe.py; the
    kernel's wrapper itself never falls back, and counts no launch."""
    from gandtr_tpu_torch.kernels import clahe as kclahe
    from gandtr_tpu_torch.ops.clahe import clahe_u8
    before = kclahe.LAUNCHES
    img = torch.zeros((2, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kclahe.clahe_u8_cuda(img, 1.0, 8)
    assert clahe_u8(img, 1.0, 8).shape == img.shape
    assert kclahe.LAUNCHES == before


def test_resblock_wrapper_takes_cuda_tensors_only():
    """The same for K3: ops/resblock.py picks the plain version for a CPU
    tensor; the wrapper raises and counts nothing."""
    from gandtr_tpu_torch.kernels import resblock as kres
    from gandtr_tpu_torch.ops.resblock import fused_resblock
    before = kres.LAUNCHES
    x = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 16, 16), dtype=torch.bfloat16)
    b = torch.zeros((16,), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kres.fused_resblock_cuda(x, w.view(144, 16), b, w.view(144, 16), b)
    assert fused_resblock(x, w, b, w, b).shape == x.shape
    assert kres.LAUNCHES == before
