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
          "learning.training", "models.backbones", "ops.pooling",
          "ops.whiten", "scenarios.multistep_stage", "models.discriminators",
          "models.hed", "learning.gan_steps", "learning.html_report",
          "scenarios.build", "scenarios.train_stage", "scenarios.engine",
          "scenarios.run", "scenarios.stages", "utils.download",
          "utils.stats", "learning.image_pool", "models.rcf",
          "models.patchsample", "ops.library", "serving.index",
          "serving.pq", "scenarios.index_stage", "scenarios.export_stage",
          "utils.file_readers", "learning.teacher_cache",
          "learning.tensorboard", "models.unet", "models.extra_layers",
          "ops.colorspace", "learning.wrappers", "data.histogram_consts",
          "models.grouping", "parallel.mesh", "native", "utils.imgtools",
          "utils.modelviz", "utils.fs_api", "models.pretrained_urls")

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


def test_the_data_side_runs_without_jax(tmp_path):
    """The histogram transforms read the port's own copy of the
    constants (data/histogram_consts.py), imported when first used; the
    colorspaces, the tuple datasets and the sinks load nothing of JAX
    either when they run."""
    code = (
        "import sys, numpy as np\n"
        "from gandtr_tpu_torch.data import transforms as T\n"
        "from gandtr_tpu_torch.data import datasets as D\n"
        "from gandtr_tpu_torch.scenarios import infer_stage as I\n"
        "img = np.random.RandomState(0).randint(0, 255, (20, 24, 3), "
        "np.uint8)\n"
        "T.initialize_transforms('pil2np | match_histogram:f3d_lab:luv | "
        "replace_histogram:eq:append | tospace:lsh', [[0.5] * 3, [0.5] * 3])"
        "(img)\n"
        "D.PregeneratedImageTupleDataset([], None, {'k': [['a', 'b']]}, "
        "'k', '', '0_any')\n"
        "I.RgbImageSaver(sys.argv[1], [[0.5] * 3, [0.5] * 3], transforms="
        "'toluv').close()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'gandtr_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_model_side_runs_without_jax():
    """The grouping layers (hard and soft assignment, per-batch
    clustering, a computed codebook), a multi-head member with a link,
    GlobalLocalModule and the compound criteria load nothing of JAX when
    they run."""
    code = (
        "import sys, torch\n"
        "from gandtr_tpu_torch.models import grouping as G\n"
        "from gandtr_tpu_torch.learning import network as N\n"
        "from gandtr_tpu_torch.learning.criteria import "
        "initialize_criterion\n"
        "f, a = torch.rand(20, 4), torch.rand(20, 1)\n"
        "for near in ('top', 'all'):\n"
        "    G.LoadedCodebook(torch.rand(8, 4).numpy(), 'res', near, "
        "'softmax-2', 'l2norm', 'maxass')([(f, a)])\n"
        "G.BatchClustering(3, 'res', 'top', 'uniform', 'l2norm', 'maxass', "
        "'kmeans', 2, outputdim=4)([(f, a)])\n"
        "G.ClusteringCodebook(3, 'res', 'top', 'uniform', 'l2norm', "
        "'maxass', outputdim=4).compute_codebook(f)\n"
        "sub = {'model': {'architecture': 'identity'}}\n"
        "nets, _ = N.build_network_set({'m': {'type': 'MultiheadNetwork', "
        "'network_order': 'b,s,h', 'runtime': {'default_output': 'b'}, "
        "'b': sub, 's': sub, 'h': sub}, 'l': {'type': 'SingleNetworkLink', "
        "'link': 'm'}})\n"
        "nets['l'].apply(torch.rand(1, 4, 4, 3))\n"
        "N.GlobalLocalModule(nets['m']).forward_local(torch.rand(1, 8, 8, "
        "3))\n"
        "initialize_criterion({'loss': 'combination_loss', 'weights': 1, "
        "'x': {'loss': 'l1'}})(f, a)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'gandtr_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_parallel_and_native_run_without_jax(tmp_path):
    """A data-parallel step over a one-rank gloo group and the native
    decoder's build and decode load nothing of JAX when they run."""
    code = (
        "import sys, os, torch, numpy as np, torch.distributed as dist\n"
        "from PIL import Image\n"
        "from gandtr_tpu_torch.parallel import mesh\n"
        "from gandtr_tpu_torch import native\n"
        "dist.init_process_group('gloo', init_method='tcp://127.0.0.1:%d' "
        "% int(sys.argv[2]), rank=0, world_size=1)\n"
        "lin = torch.nn.Linear(3, 2)\n"
        "opt = torch.optim.Adam(lin.parameters())\n"
        "mesh.attach_optimizers([opt])\n"
        "def step(state, x):\n"
        "    opt.zero_grad(); loss = lin(x).square().mean(); loss.backward()"
        "; opt.step(); return state, {'total': loss.detach()}\n"
        "s = mesh.data_parallel_step(step)\n"
        "assert s.gandtr_dp and s(None, torch.ones(4, 3))[1]['total'] > 0\n"
        "p = os.path.join(sys.argv[1], 'a.png')\n"
        "Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(p)\n"
        "assert native.decode(p).shape == (4, 5, 3), native.build_error()\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'gandtr_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    from torch_dp_workers import free_port
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(free_port())], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_native_and_parallel_are_the_ports_own():
    """native/loader.cc is the port's own copy of the JAX package's source
    (its C API and ABI the same, its header naming the port), built into
    the port's ignored _build/ and never committed as a .so; no path in
    native/ or parallel/ points into gandtr_tpu/."""
    ours = (PKG / "native" / "loader.cc").read_text()
    theirs = (PKG.parent / "gandtr_tpu" / "native" / "loader.cc").read_text()
    assert ours != theirs and "gandtr_tpu_torch" in ours.split("#include")[0]
    body = ours[ours.index("#include <cstdio>"):]
    assert body == theirs[theirs.index("#include <cstdio>"):]
    assert not list(PKG.rglob("*.so")) or all(
        p.parent.name == "_build" for p in PKG.rglob("*.so"))
    tracked = subprocess.run(["git", "ls-files", "gandtr_tpu_torch"],
                             cwd=PKG.parent, capture_output=True, text=True)
    assert not [f for f in tracked.stdout.split() if f.endswith(".so")]
    for sub in ("native", "parallel"):
        for path in (PKG / sub).rglob("*"):
            if path.suffix in (".py", ".cc"):
                text = path.read_text()
                assert "gandtr_tpu/" not in text.replace(
                    "gandtr_tpu/native/__init__.py", "").replace(
                    "gandtr_tpu/parallel/mesh.py", ""), path
                assert "import gandtr_tpu\n" not in text, path


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
                                   "hedngan", "finetune", "validate",
                                   "gem_resnet101_cyclegan",
                                   "gem_resnet101_hedngan", "infer",
                                   "infer_and_learn_whitening", "train",
                                   "gan_build", "infer_image",
                                   "run_target", "load_artifact",
                                   "build_index", "export_stage",
                                   "retrieval_index", "pq_index"])
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
        elif entry == "train":
            from gandtr_tpu_torch.scenarios.train_stage import train
            train({"network": {"type": "NetworkSet"}, "learning": {}}, ())
        elif entry == "gan_build":
            from gandtr_tpu_torch.scenarios.build import build_gan_experiment
            build_gan_experiment({"network": {}, "learning": {}})
        elif entry == "infer":
            from gandtr_tpu_torch.scenarios.infer_stage import infer
            infer({"network": {}, "output": {"type": "embedding"}}, ([],))
        elif entry == "infer_image":
            from gandtr_tpu_torch.scenarios.infer_stage import infer
            infer({"network": {}, "output": {"type": "image"}}, ([],))
        elif entry == "run_target":
            from gandtr_tpu_torch.scenarios.run import run_target
            run_target({"t": {"1_v": {"__function__": "mdir.stages.validate"
                                      ".validate", "network": {},
                                      "validation": {}}}}, "t", "s")
        elif entry == "load_artifact":
            from gandtr_tpu_torch.serving import load_artifact
            load_artifact("no_such_artifact")
        elif entry == "build_index":
            from gandtr_tpu_torch.scenarios.index_stage import build_index
            build_index({"network": {}, "index": {
                "path": "no_such_index.npz", "skip_if_exists": False}},
                ([],))
        elif entry == "export_stage":
            from gandtr_tpu_torch.scenarios.export_stage import export
            export({"network": {}, "export": {}}, ())
        elif entry == "retrieval_index":
            from gandtr_tpu_torch.serving import RetrievalIndex
            RetrievalIndex(8)
        elif entry == "pq_index":
            from gandtr_tpu_torch.serving import PQRetrievalIndex
            PQRetrievalIndex(8, m=2)
        elif entry == "infer_and_learn_whitening":
            from gandtr_tpu_torch.scenarios.multistep_stage import \
                infer_and_learn_whitening
            infer_and_learn_whitening({"whitening": {
                "type": "lw", "dataset_pkl": "w.pkl", "directory": None},
                "network": {}}, None)
        else:
            getattr(hub, entry)(pretrained=False)



def test_every_gan_family_has_its_step():
    """GAN_STEPS builds all four families of the paper with their own
    builders; nothing in it is a "not ported" stand-in."""
    from gandtr_tpu_torch.learning import gan_steps
    from gandtr_tpu_torch.models import MODEL_LABELS
    assert {k: v.__name__ for k, v in gan_steps.GAN_STEPS.items()} == {
        "hedngan": "build_hedngan_step", "hedgan": "build_hedgan_step",
        "cut": "build_cut_step", "cyclegan": "build_cyclegan_step"}
    assert not hasattr(gan_steps, "_not_ported")
    assert {"rcf", "official_p2p_mlp"} <= set(MODEL_LABELS)


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
