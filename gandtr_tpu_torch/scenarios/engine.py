"""The YAML scenario engine (counterpart of gandtr_tpu/scenarios/engine.py;
the reference's mdir/tools/utils.py:21-112): overlay chains of files,
`__template__` includes, `${var}` resolution and the `key*` / `key+`
operators. Pure Python and YAML: a scenario loads here exactly as it
loads in the JAX package.

    scenario = load_yaml_scenario(["train/hedngan.yml", "a.b=1"])
    resolve_variables(section, context)       # in place, returns section
"""
import copy
import json
import os
import re
from functools import reduce

import yaml


def deep_set(params, deep_key, value):
    """params[k0][k1]...[kn] = value, making the dicts on the way."""
    reduce(lambda x, y: x.setdefault(y, {}), deep_key[:-1],
           params)[deep_key[-1]] = value
    return params


def get_deeply(data, field, ignore_nonexistent=False, support_list=False):
    """Nested access along `field`, a list of path segments; with
    `support_list`, a decimal segment indexes a list."""
    if not isinstance(field, (list, tuple)):
        return data.get(field, {}) if ignore_nonexistent else data[field]
    if not field:
        return data
    if support_list and isinstance(data, (list, tuple)):
        if isinstance(field[0], str) and not field[0].isdecimal() \
                and ignore_nonexistent:
            return []
        idx = int(field[0])
        nxt = [] if ignore_nonexistent and idx >= len(data) else data[idx]
        return get_deeply(nxt, field[1:], ignore_nonexistent, support_list)
    if not isinstance(data, dict):
        raise ValueError("Cannot access field '%s' of non-dictionary '%s'"
                         % (field, data))
    nxt = data.get(field[0], {}) if ignore_nonexistent else data[field[0]]
    return get_deeply(nxt, field[1:], ignore_nonexistent, support_list)


def dict_deep_overlay(*data, list_replace=False):
    """Overlay the trees left to right: dicts merge key by key, `key*`
    replaces, `key+` appends; two lists do not merge implicitly."""
    if len(data) == 1:
        return data[0]
    if len(data) != 2:
        head = dict_deep_overlay(data[0], data[1], list_replace=list_replace)
        return dict_deep_overlay(head, *data[2:], list_replace=list_replace)

    original, overlay = data
    if isinstance(original, (list, tuple)) and isinstance(overlay, dict):
        for key, item in overlay.items():
            assert isinstance(key, int)
            original[key] = dict_deep_overlay(original[key], item)
    elif not isinstance(original, type(overlay)):
        return overlay
    elif isinstance(overlay, dict):
        for key, item in overlay.items():
            if isinstance(key, str) and key.endswith("*"):
                original[key[:-1]] = item
            elif isinstance(key, str) and key.endswith("+"):
                original[key[:-1]] += item
            elif key not in original:
                original[key] = item
            else:
                original[key] = dict_deep_overlay(original[key], item,
                                                  list_replace=list_replace)
    elif isinstance(overlay, list) and not list_replace:
        raise ValueError("Cannot implicitly merge two lists, use key* or "
                         "key+ when inheriting: (%s, %s)"
                         % (original, overlay))
    else:
        return overlay
    return original


def load_yaml_scenario(scenarios):
    """Load and overlay a chain of YAML files and `a.b.c=value` overrides;
    later ones win. The overrides (JSON values; a trailing `+` appends to
    a list, `*` replaces) apply after the files are loaded and their
    templates expanded, so they always win; an override through a scalar
    replaces that scalar with a dict."""
    files, overrides = [], []
    for spec in scenarios:
        if spec.endswith(".yml") or spec.endswith(".yaml"):
            files.append(spec)
        elif "=" in spec:
            overrides.append(spec)
        else:
            raise ValueError("Unsupported scenario spec: %s" % spec)
    scenario = _load_yaml_files(files) if files else {}
    for spec in overrides:
        deep_key, value = spec.split("=", 1)
        keys = deep_key.split(".")
        value = json.loads(value)
        if keys[-1].endswith("+"):
            keys[-1] = keys[-1][:-1]
            try:
                existing = get_deeply(scenario, keys, ignore_nonexistent=True)
            except (TypeError, ValueError):     # a scalar on the way
                existing = None
            value = (existing or []) + value
        elif keys[-1].endswith("*"):
            keys[-1] = keys[-1][:-1]
        node = scenario
        for k in keys[:-1]:
            nxt = node.get(k) if isinstance(node, dict) else None
            if not isinstance(nxt, dict):
                nxt = {}
                node[k] = nxt
            node = nxt
        node[keys[-1]] = value
    return scenario


def _load_yaml_files(scenarios):
    """The first file overlaid with the rest, templates expanded from the
    first file's directory."""
    first = scenarios[0]
    with open(first) as handle:
        scenario = yaml.safe_load(handle)
    if scenarios[1:]:
        scenario = dict_deep_overlay(scenario, _load_yaml_files(scenarios[1:]))
    return load_nested_templates(scenario, os.path.dirname(first))


def load_nested_templates(params, root_path):
    """Expand `__template__` includes at every level, dotted keys first set
    deeply; a template may itself name a template (a chain like rcfgan.yml
    -> hedgan.yml -> parameters/train_hedgan.yml -> train_hedngan.yml),
    each resolved from its own file's directory."""
    if not isinstance(params, dict):
        return params
    while "__template__" in params:
        for key in list(params.keys()):
            if isinstance(key, str) and "." in key:
                deep_set(params, key.split("."), params.pop(key))
        path = os.path.join(root_path, params.pop("__template__"))
        with open(path) as handle:
            template = yaml.safe_load(handle)
        params = dict_deep_overlay(template, params)
        root_path = os.path.dirname(path)
    for key, value in params.items():
        params[key] = load_nested_templates(copy.copy(value), root_path)
    return params


_VAR_RE = re.compile(r"\$\{([A-Za-z_\-0-9.]+)\}")


def _resolve_single_variable(hit, data, reference):
    try:
        var_value = copy.deepcopy(get_deeply(reference, hit.split("."),
                                             support_list=True))
    except KeyError:
        raise ValueError("Variable '%s' in '%s' cannot be expanded"
                         % (hit, data))
    var_value = resolve_variables(var_value, reference)
    if data == "${%s}" % hit:
        return var_value
    return data.replace("${%s}" % hit, str(var_value))


def resolve_variables(data, reference):
    """Expand every `${dotted.path}` in `data` (keys too) against
    `reference`, recursively and in place; a string that is one variable
    takes the variable's value, any other its str()."""
    if isinstance(data, str):
        for hit in sorted(set(_VAR_RE.findall(data)), reverse=True):
            data = _resolve_single_variable(hit, data, reference)
    elif isinstance(data, dict):
        for key, value in list(data.items()):
            newkey = resolve_variables(key, reference)
            if newkey != key:
                del data[key]
            data[newkey] = resolve_variables(value, reference)
    elif isinstance(data, list):
        for i, value in enumerate(data):
            data[i] = resolve_variables(value, reference)
    return data
