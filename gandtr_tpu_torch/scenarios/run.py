"""The scenario CLI (counterpart of gandtr_tpu/scenarios/run.py; the
reference's mdir/examples/perform_scenario.py): load and overlay YAML
scenarios, list or validate their targets, and run a target's steps in
sorted order, each step's parameters resolved against the context of the
steps before it (`${<step>.parameters.<key>}`,
`${<step>._output_metadata.<key>}`, `${SCENARIO_NAME}`).

    python -m gandtr_tpu_torch.scenarios.run <target|list|validate|doctor>
        scenario.yml [overlay.yml ...] [section.key=value ...]
        [--device cpu]

The scenario files are the JAX package's (gandtr_tpu/scenarios/configs/
iccv23/...), read as any YAML file; their function names (`gandtr_tpu.
stages.*`, `mdir.stages.*`, the download names, the whitening stages and
`print_scores`) map onto the port's stages here. Relative paths resolve
under $GANDTR_ROOT. An infer step (the `output` target) takes its image
names from stdin, one a line. The stages run on cuda unless `--device
cpu` (or `run_target(..., device="cpu")`).

Data-parallel over N cards, one process a card (parallel/mesh.py):

    torchrun --nproc-per-node N -m gandtr_tpu_torch.scenarios.run <target>
        scenario.yml ...

Every rank runs the target; the train steps split each batch over the
ranks, extraction splits the images, and rank 0 alone writes.
"""
import argparse
import copy
import importlib
import io
import sys

import torch

from gandtr_tpu_torch.parallel import mesh
from gandtr_tpu_torch.scenarios.engine import (load_yaml_scenario,
                                               resolve_variables)
from gandtr_tpu_torch.scenarios import stages as whiten_stages
from gandtr_tpu_torch.utils import download
from gandtr_tpu_torch.utils.io import resolve_path


def print_scores(parameters, _data):
    """Print the published mAPs of a validate step's metadata. The
    validate stage's metadata nests its sections under "metadata" (the
    JAX package's form), so that level is looked through; the JAX
    print_scores does not, and prints no score of its own validate."""
    scores = {
        "roxford5k/validation/score_avg:map_medium": "roxford.5k medium",
        "rparis6k/validation/score_avg:map_medium": "rparis.6k medium",
        "247tokyo1k/validation/score_avg:map": "247tokyo.1k",
        "val/validation/roxford5k/score_avg:map_medium": "roxford.5k medium",
        "val/validation/rparis6k/score_avg:map_medium": "rparis.6k medium",
    }
    assert parameters.keys() == {"metadata"}, parameters.keys()
    metadata = parameters["metadata"]
    if set(metadata) == {"metadata"}:
        metadata = metadata["metadata"]
    for heading, section in metadata.items():
        print("\n%s\n" % heading.capitalize())
        for key, value in section.items():
            if key in scores:
                print("    %-20s %s" % (scores[key], round(100 * value, 2)))
        print()
    return ({},)


def _on_device(module, name):
    """The port's stage `module.name`, which takes the device."""
    def run(params, data, device):
        mod = importlib.import_module("gandtr_tpu_torch.scenarios." + module)
        return getattr(mod, name)(params, data, device=device)
    return run


def _on_host(fn):
    return lambda params, data, device: fn(params, data)


def _download(name):
    """A layout check of utils/download.py under $GANDTR_ROOT/data."""
    def run(params, data, device):
        getattr(download, name)(resolve_path("data"))
        return ({},)
    return run


_TRAIN = _on_device("train_stage", "train")
_INFER = _on_device("infer_stage", "infer")
_INCREMENTAL = _on_device("infer_stage", "infer_incrementally")
_VALIDATE = _on_device("validate_stage", "validate")
_WHITENING = _on_device("multistep_stage", "infer_and_learn_whitening")
_RSFM120K = _download("rsfm120k")
_TEST_SETS = _download("roxf5k_rpar6k_247tokyo1k")

#: the configs' function names (the JAX table's and the reference's) ->
#: the port's stages, each called as fn(params, data, device)
FUNCTIONS = {
    "gandtr_tpu.stages.train": _TRAIN,
    "gandtr_tpu.stages.infer": _INFER,
    "gandtr_tpu.stages.validate": _VALIDATE,
    **{name: _on_host(fn) for name, fn in whiten_stages.FUNCTIONS.items()},
    "mdir.stages.train.train": _TRAIN,
    "mdir.stages.validate.validate": _VALIDATE,
    "mdir.stages.infer.infer": _INFER,
    "gandtr_tpu.stages.infer_incrementally": _INCREMENTAL,
    "gandtr_tpu.stages.export": _on_device("export_stage", "export"),
    "gandtr_tpu.stages.build_index": _on_device("index_stage",
                                                "build_index"),
    "mdir.stages.infer.infer_incrementally": _INCREMENTAL,
    "mdir.stages.multistep.infer_and_learn_whitening": _WHITENING,
    "gandtr_tpu.stages.multistep.infer_and_learn_whitening": _WHITENING,
    "gandtr_tpu.utils.download.rsfm120k": _RSFM120K,
    "gandtr_tpu.utils.download.roxf5k_rpar6k_247tokyo1k": _TEST_SETS,
    "cirtorch.utils.download.download_train": _RSFM120K,
    "cirtorch.utils.download.download_test": _TEST_SETS,
    "mdir.utils.download.rsfm120k": _RSFM120K,
    "mdir.utils.download.roxf5k_rpar6k_247tokyo1k": _TEST_SETS,
    "print_scores": _on_host(print_scores),
}

#: the steps that take the names read from stdin as their data
NEEDS_DATA = {"mdir.stages.infer.infer", "gandtr_tpu.stages.infer",
              "gandtr_tpu.stages.build_index"}


def parse_targets(scenario, targets):
    """[(target, [(step, function name, section)])], the steps in sorted
    order without the `_`-prefixed keys; raises for an unknown function.
    Pops each section's `__function__`."""
    acc = []
    for target in targets:
        target_acc = []
        steps = {x: scenario[target][x] for x in sorted(scenario[target])
                 if not x.startswith("_")}
        for step, section in steps.items():
            if not isinstance(section, dict):
                continue
            function = section.pop("__function__", None)
            if function not in FUNCTIONS:
                raise ValueError("Step '%s' in target '%s' needs undefined "
                                 "function '%s'" % (step, target, function))
            target_acc.append((step, function, section))
        acc.append((target, target_acc))
    return acc


def derive_scenario_name(specs):
    """${SCENARIO_NAME}: the last YAML file's stem (the reference's
    perform_scenario.py:116). A key=value override never counts, as
    load_yaml_scenario tells them apart (by the .yml / .yaml ending); the
    JAX package counts an override whose value ends in a path
    (`a.b="x/y.pkl"`) as a file."""
    yaml_specs = [s for s in specs if s.endswith((".yml", ".yaml"))]
    return (yaml_specs[-1] if yaml_specs else specs[-1]) \
        .rsplit("/", 1)[-1].rsplit(".", 1)[0]


def run_target(scenario, target, scenario_name, stdin_data=None,
               device=None):
    """Run one target's steps in order; returns {step: its metadata}. Each
    step's context entry holds its parameters dict, which
    `resolve_variables` resolves in place, so a later step's
    `${<step>.parameters.<key>}` reads the resolved value; its metadata
    goes into the context as `_output_metadata`."""
    (_, steps), = parse_targets(scenario, [target])
    context = {"SCENARIO_NAME": scenario_name}
    results = {}
    for step, function, section in steps:
        context[step] = {"function": function, "parameters": section}
        params = resolve_variables(section, context)
        params.pop("__doc__", None)
        data = ()
        if function in NEEDS_DATA and stdin_data is not None:
            data = (stdin_data,)
        print(">> %s: %s" % (step, function), flush=True)
        out = FUNCTIONS[function](copy.deepcopy(params), data, device)
        metadata = out[0] if out else {}
        context[step]["_output_metadata"] = metadata
        results[step] = metadata
    return results


def decoder_line():
    """Which image decoder the data path runs: the native one (native/)
    where it built and is on, else PIL, with the build error."""
    import os
    from gandtr_tpu_torch import native
    if os.environ.get("GANDTR_TPU_NATIVE_LOADER", "1") == "0":
        return "decoder: PIL (GANDTR_TPU_NATIVE_LOADER=0)"
    if native.available():
        return "decoder: native (%s)" % native.library_path().name
    lines = str(native.build_error()).strip().splitlines() or ["?"]
    why = next((ln for ln in lines if "error" in ln), lines[-1])
    return "decoder: PIL (the native decoder did not build: %s)" % why.strip()


def doctor():
    """The card, the compiler and the kernels: torch's version, the CUDA
    device's name and count, nvcc, whether each csrc/*.cu source builds
    (kernels/_build.py), and which image decoder runs (native/: PIL where
    it did not build, which is no failure). Returns 1 on any failure."""
    from gandtr_tpu_torch.kernels import _build
    ok = True
    print("gandtr_tpu_torch doctor")
    print("  torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))
    print("  " + decoder_line())
    if torch.cuda.is_available():
        print("  device: %s, %d visible" % (torch.cuda.get_device_name(0),
                                            torch.cuda.device_count()))
    else:
        print("  device: no CUDA device (the stages need device='cpu')")
        ok = False
    try:
        print("  nvcc: %s" % _build._nvcc())
    except RuntimeError as e:
        print("  nvcc: %s" % e)
        return 1
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    try:
        for name, so in _build.build(names).items():
            print("  built %s -> %s" % (name, so.name))
    except RuntimeError as e:
        print("  build FAILED: %s" % e)
        ok = False
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("action",
                        help="target name, 'list', 'validate' or 'doctor'")
    parser.add_argument("scenario", nargs="*",
                        help="yaml files / key=value overrides (later wins)")
    parser.add_argument("--device", default=None,
                        help="the stages' device (default: cuda)")
    args = parser.parse_args(argv)

    if args.action == "doctor":
        return doctor()
    # under torchrun: join the process group (nothing without WORLD_SIZE)
    mesh.init_distributed()
    if not args.scenario:
        parser.error("scenario yaml required for action %r" % args.action)

    scenario = load_yaml_scenario(args.scenario)
    targets = [k for k in scenario if isinstance(scenario.get(k), dict)]

    if args.action == "list":
        for t in targets:
            print("%-12s %s" % (t, scenario[t].get("__doc__", "")))
        return 0
    if args.action == "validate":
        parse_targets(scenario, targets)
        print("OK: %d targets, all step functions resolve" % len(targets))
        return 0

    stdin_data = None
    if not sys.stdin.isatty():
        try:
            stdin_data = [x.strip() for x in sys.stdin.readlines()
                          if x.strip()]
        except (OSError, ValueError, io.UnsupportedOperation):
            stdin_data = None
    run_target(scenario, args.action, derive_scenario_name(args.scenario),
               stdin_data, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
