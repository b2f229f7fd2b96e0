"""The port's scenario engine and CLI tables (scenarios/engine.py,
scenarios/run.py) against the JAX package's: both are pure Python and
YAML, so every result must be equal. Every iccv23 YAML file loads to the
same tree, every target parses to the same steps and function names, and
`list` / `validate` print the same; the override, template and variable
cases of tests/test_scenarios.py and tests/test_scenario_cli_semantics.py,
and seeded random contexts for `resolve_variables`, give the same
results."""
import copy
import glob
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from gandtr_tpu.scenarios import engine as jengine
from gandtr_tpu.scenarios import run as jrun
from gandtr_tpu_torch.scenarios import engine
from gandtr_tpu_torch.scenarios import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICCV23 = os.path.join(ROOT, "gandtr_tpu", "scenarios", "configs", "iccv23")
YMLS = sorted(glob.glob(os.path.join(ICCV23, "*", "*.yml")))
# the scenario files (the parameter files and templates hold no targets)
SCENARIOS = [p for p in YMLS if "/parameters/" not in p
             and not os.path.basename(p).startswith("_")]


def _rel(path):
    return os.path.relpath(path, ICCV23)


def test_every_iccv23_file_is_found():
    assert len(YMLS) == 19 and len(SCENARIOS) == 8


@pytest.mark.parametrize("path", YMLS, ids=_rel)
def test_load_yaml_scenario_equals_jax(path):
    assert engine.load_yaml_scenario([path]) == \
        jengine.load_yaml_scenario([path])


def _steps(module, path):
    scenario = module.load_yaml_scenario([path])
    targets = [k for k in scenario if isinstance(scenario.get(k), dict)]
    return [(t, [(step, fn, section) for step, fn, section in steps])
            for t, steps in module.parse_targets(scenario, targets)]


@pytest.mark.parametrize("path", SCENARIOS, ids=_rel)
def test_parse_targets_equals_jax(path):
    """The same steps in the same order, the same function names and
    sections; and every function name the JAX table knows the port's
    knows."""
    got, want = _steps(run, path), _steps(jrun, path)
    assert got == want
    for _, steps in got:
        for _, fn, _ in steps:
            assert fn in run.FUNCTIONS


def _cli(module, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("action", ["list", "validate"])
@pytest.mark.parametrize("path", SCENARIOS, ids=_rel)
def test_list_and_validate_print_as_jax(path, action):
    assert _cli(run, [action, path]) == _cli(jrun, [action, path])


def test_function_names_cover_the_jax_table():
    assert set(run.FUNCTIONS) == set(jrun.FUNCTIONS)
    assert run.NEEDS_DATA == jrun.NEEDS_DATA


@pytest.mark.parametrize("name", ["gandtr_tpu.stages.infer_incrementally",
                                  "gandtr_tpu.stages.export",
                                  "gandtr_tpu.stages.build_index",
                                  "mdir.stages.infer.infer_incrementally"])
def test_stages_not_ported_raise_when_they_run(name):
    """These stages raised NotImplementedError until they were ported; now
    each runs the port's stage, and a step without parameters fails there
    as the JAX package's stage fails."""
    with pytest.raises(Exception) as want:
        jrun.run_target({"t": {"1_x": {"__function__": name}}}, "t", "s")
    with pytest.raises(type(want.value)) as got:
        run.run_target({"t": {"1_x": {"__function__": name}}}, "t", "s",
                       device="cpu")
    assert not isinstance(got.value, NotImplementedError)


def _files(tmp_path, files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return [str(tmp_path / n) if n.endswith(".yml") else n for n in files]


OVERRIDES = {
    "cli_override": ({"s.yml": "a:\n  b: 1\n"}, ["a.b=7"]),
    "append_through_scalar": ({"s.yml": "beta: day\n"}, ["beta.x+=[1]"]),
    "append_to_list": ({"s.yml": "beta:\n  x: [0]\n"}, ["beta.x+=[1]"]),
    "replace": ({"s.yml": "a:\n  l: [1, 2]\n"}, ["a.l*=[3]"]),
    "new_branch": ({"s.yml": "a: 1\n"}, ["b.c.d=\"x\"", "a=2"]),
    "template": ({"base.yml": "x:\n  y: 1\n  z: 2\n",
                  "main.yml": "section:\n  __template__: base.yml\n"
                              "  x.y: 9\n"}, ["section.x.z=5"]),
    "overlay_chain": ({"a.yml": "t:\n  s:\n    k: 1\n    l: [1]\n",
                       "b.yml": "t:\n  s:\n    k: 2\n    l+: [2]\n"}, []),
    "chained_templates": ({"c.yml": "x: {y: 1, z: 1, w: 1}\n",
                           "b.yml": "__template__: c.yml\nx.z: 2\n",
                           "a.yml": "s:\n  __template__: b.yml\n  x.w: 3\n"},
                          []),
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_overrides_and_templates_equal_jax(tmp_path, case):
    files, overrides = OVERRIDES[case]
    specs = [p for p in _files(tmp_path, files)
             if not p.endswith(("base.yml", "c.yml", "b.yml"))
             or case == "overlay_chain"] + overrides
    assert engine.load_yaml_scenario(list(specs)) == \
        jengine.load_yaml_scenario(list(specs))


def test_overlay_operators_equal_jax():
    a = {"x": {"l": [1, 2], "k": 1}, "keep": "yes"}
    b = {"x": {"l*": [3], "k": 2, "new": 5}}
    assert engine.dict_deep_overlay(copy.deepcopy(a), copy.deepcopy(b)) == \
        jengine.dict_deep_overlay(copy.deepcopy(a), copy.deepcopy(b))
    assert engine.dict_deep_overlay({"l": [1]}, {"l+": [2]}) == {"l": [1, 2]}
    for module in (engine, jengine):
        with pytest.raises(ValueError, match="implicitly merge"):
            module.dict_deep_overlay({"l": [1]}, {"l": [2]})


def _random_context(rs):
    """A seeded context of nested dicts and lists, and data that refers
    into it: whole-string variables, embedded ones, keys, list indices."""
    ctx = {"SCENARIO_NAME": "exp%d" % rs.randint(100)}
    for i in range(4):
        ctx["s%d" % i] = {"parameters": {
            "n": int(rs.randint(1000)), "f": float(rs.rand()),
            "l": [int(x) for x in rs.randint(0, 9, 3)],
            "d": {"path": "/p/%d" % rs.randint(50)}}}
    ctx["s3"]["parameters"]["ref"] = "${s0.parameters.d.path}/x"
    picks = ["${s%d.parameters.n}", "pre_${s%d.parameters.f}_post",
             "${s%d.parameters.l.1}", "${s%d.parameters.d}",
             "${SCENARIO_NAME}/${s%d.parameters.d.path}",
             "${s3.parameters.ref}"]
    data = {}
    for j in range(6):
        pick = picks[rs.randint(len(picks))]
        value = pick % rs.randint(4) if "%d" in pick else pick
        data["k%d" % j] = [value] if rs.rand() < 0.3 else value
    data["${SCENARIO_NAME}_key"] = "${s1.parameters.n}"
    return data, ctx


@pytest.mark.parametrize("seed", range(6))
def test_resolve_variables_equals_jax(seed):
    data, ctx = _random_context(np.random.RandomState(seed))
    got = engine.resolve_variables(copy.deepcopy(data), copy.deepcopy(ctx))
    want = jengine.resolve_variables(copy.deepcopy(data), copy.deepcopy(ctx))
    assert got == want
    assert not any("${" in str(v) for v in got.values())


def test_unresolvable_variable_raises_in_both():
    for module in (engine, jengine):
        with pytest.raises(ValueError, match="cannot be expanded"):
            module.resolve_variables({"a": "${nope.x}"}, {"b": 1})


@pytest.mark.parametrize("specs", [
    ["base.yml", "conf/rcfgan.yml"],
    ["base.yml", "dir/cut.yml", "train.epochs=3"],
    ["a/b/hedngan.yml"],
    ["x.yaml", "a.b=c/d.yml"],
])
def test_derive_scenario_name_equals_jax(specs):
    assert run.derive_scenario_name(specs) == \
        jrun.derive_scenario_name(specs)


def test_an_override_with_a_path_value_is_no_scenario_name():
    """The port names the scenario after its last YAML file whatever an
    override's value holds; the JAX package takes the value's file."""
    specs = ["t/hedngan.yml", 'all.x.dataset_pkl="data/w-whiten.pkl"']
    assert run.derive_scenario_name(specs) == "hedngan"
    assert jrun.derive_scenario_name(specs) == "w-whiten"


def test_print_scores_reads_the_validate_metadata(capsys):
    """The validate stage's metadata, as the `all` target hands it on:
    the port prints its scores, the JAX print_scores prints none."""
    val = {"metadata": {"validation": {
        "roxford5k/validation/score_avg:map_medium": 0.5,
        "247tokyo1k/validation/score_avg:map": 0.25,
        "config:data.shape_bucket": 64}}}
    assert run.print_scores({"metadata": val}, ()) == ({},)
    out = capsys.readouterr().out
    assert "roxford.5k medium" in out and "50.0" in out and \
        "247tokyo.1k" in out and "25.0" in out
    jrun.print_scores({"metadata": val}, ())
    assert "roxford" not in capsys.readouterr().out
    run.print_scores({"metadata": val["metadata"]}, ())
    assert "roxford.5k medium" in capsys.readouterr().out
