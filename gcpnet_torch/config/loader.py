"""Hydra-compatible YAML composer: the port's own copy of
``gcpnet_tpu/config/loader.py``, so that the port composes ``configs/``
exactly as the JAX entry points do, without importing that package.

It covers the subset of Hydra 1.2 the config tree uses:

- ``defaults:`` lists with group selection (``- datamodule: nms.yaml``),
  ``_self_`` ordering, ``null`` groups, ``optional`` entries and
  experiment-package ``- override /group: option`` entries;
- ``# @package _global_`` experiment files merged at the root;
- ``${a.b}`` absolute, ``${..rel}`` relative, and ``${oc.env:VAR,default}``
  interpolations;
- CLI dotlist overrides: ``key.sub=val``, group selection ``group=option``,
  ``experiment=name``, ``++forced.add=val``, ``~deleted.key``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Sequence

import yaml


# the repository's config tree, which both packages compose
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")


class ConfigError(Exception):
    pass


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"{path} must contain a mapping")
    return data


def _deep_merge(base: Dict, new: Dict) -> Dict:
    out = dict(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _is_global_package(path: str) -> bool:
    try:
        with open(path) as f:
            head = f.read(200)
        return "@package _global_" in head
    except OSError:
        return False


def _option_path(config_dir: str, group: str, option: str) -> str:
    option = option if option.endswith((".yaml", ".yml")) else option + ".yaml"
    return os.path.join(config_dir, group, option)


def _compose_file(
    config_dir: str,
    rel_path: str,
    group_prefix: str,
    selections: Dict[str, str],
) -> Dict[str, Any]:
    """Compose one YAML file, resolving its defaults list.

    ``group_prefix`` is the group dir the file lives in ("" for root);
    nested group defaults resolve relative to it.  ``selections`` collects
    ``override /group: option`` requests for the root composer.
    """
    path = os.path.join(config_dir, rel_path)
    raw = _load_yaml(path)
    defaults = raw.pop("defaults", [])

    before: Dict[str, Any] = {}
    after: Dict[str, Any] = {}
    in_after = False
    seen_self = False

    for entry in defaults:
        if entry == "_self_":
            seen_self = True
            in_after = True
            continue
        if isinstance(entry, str):
            # bare include from the same group dir, merged at this level
            inc_rel = os.path.join(
                group_prefix,
                entry if entry.endswith((".yaml", ".yml")) else entry + ".yaml",
            )
            inc = _compose_file(config_dir, inc_rel, group_prefix, selections)
            if in_after:
                after = _deep_merge(after, inc)
            else:
                before = _deep_merge(before, inc)
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ConfigError(f"unsupported defaults entry {entry!r} in {path}")
        key, option = next(iter(entry.items()))
        key = str(key)
        optional = False
        if key.startswith("optional "):
            optional = True
            key = key[len("optional ") :]
        if key.startswith("override "):
            # experiment-style override of a parent group selection
            sel = key[len("override ") :].lstrip("/")
            selections[sel] = option
            continue
        if option is None or key == "hydra":
            continue
        group = os.path.join(group_prefix, key) if group_prefix else key
        opath = _option_path(config_dir, group, str(option))
        if not os.path.exists(opath):
            if optional:
                continue
            raise ConfigError(f"missing config {opath} (from {path})")
        sub = _compose_file(
            config_dir, os.path.relpath(opath, config_dir), group, selections
        )
        merged_sub = sub if _is_global_package(opath) else {key: sub}
        if in_after:
            after = _deep_merge(after, merged_sub)
        else:
            before = _deep_merge(before, merged_sub)

    # defaults with no _self_: file's own content wins (hydra 1.2 appends
    # _self_ at the end by default)
    if not seen_self:
        return _deep_merge(_deep_merge(before, after), raw)
    return _deep_merge(_deep_merge(before, raw), after)


_INTERP = re.compile(r"\$\{([^{}]+)\}")


def _resolve_path(root: Any, node_path: List[str], expr: str) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        body = expr[len("oc.env:") :]
        parts = body.split(",", 1)
        var = parts[0].strip()
        default = parts[1].strip() if len(parts) > 1 else None
        return os.environ.get(var, default)
    if expr.startswith("hydra:"):
        if "output_dir" in expr:
            return root.get("paths", {}).get("output_dir_runtime", "logs/run")
        if "cwd" in expr:
            return os.getcwd()
        return ""
    if expr.startswith("."):
        # relative: one leading dot = current node's container, each
        # additional dot moves one level up
        ups = len(expr) - len(expr.lstrip("."))
        rest = expr.lstrip(".")
        base_path = node_path[: len(node_path) - (ups - 1)] if ups > 1 else node_path
        node = root
        for p in base_path:
            node = node[p]
        cur: Any = node
    else:
        rest = expr
        cur = root
    for part in [p for p in rest.split(".") if p]:
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            raise ConfigError(f"cannot resolve interpolation '{expr}'")
    return cur


def _interpolate(root: Any, node: Any, node_path: List[str]) -> Any:
    if isinstance(node, dict):
        return {
            k: _interpolate(root, v, node_path + [k]) for k, v in node.items()
        }
    if isinstance(node, list):
        # list elements' container is the list node itself: append a dummy
        # component so the generic strip-last logic yields the list's path
        return [_interpolate(root, v, node_path + ["[]"]) for v in node]
    if isinstance(node, str):
        full = _INTERP.fullmatch(node)
        if full:
            val = _resolve_path(root, node_path[:-1], full.group(1))
            return _interpolate(root, val, node_path) if isinstance(val, str) else val

        def sub(m):
            val = _resolve_path(root, node_path[:-1], m.group(1))
            return "" if val is None else str(val)

        return _INTERP.sub(sub, node)
    return node


def _parse_value(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _set_dotted(cfg: Dict, dotted: str, value: Any):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ConfigError(f"cannot descend into non-dict at '{p}'")
    node[parts[-1]] = value


def _del_dotted(cfg: Dict, dotted: str):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.get(p, {})
    node.pop(parts[-1], None)


def compose(
    config_dir: str,
    config_name: str = "train.yaml",
    overrides: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Compose a config the way the reference's Hydra entrypoint does."""
    overrides = list(overrides or [])
    config_dir = os.path.abspath(config_dir)

    # split overrides into group selections vs value overrides
    group_sel: Dict[str, str] = {}
    value_overrides: List[str] = []
    deletions: List[str] = []
    for ov in overrides:
        if ov.startswith("~"):
            deletions.append(ov[1:])
            continue
        forced = ov.startswith("++") or ov.startswith("+")
        body = ov.lstrip("+")
        if "=" not in body:
            raise ConfigError(f"override '{ov}' must be key=value")
        key, val = body.split("=", 1)
        if (
            "." not in key
            and os.path.isdir(os.path.join(config_dir, key))
            and not forced
        ):
            group_sel[key] = val
        else:
            value_overrides.append((key, val))

    selections: Dict[str, str] = {}
    cfg = _compose_file(config_dir, config_name, "", selections)

    # apply experiment package (and its group overrides) if selected
    exp = group_sel.pop("experiment", None)
    exp_cfg: Dict[str, Any] = {}
    if exp:
        epath = _option_path(config_dir, "experiment", exp)
        if not os.path.exists(epath):
            raise ConfigError(f"unknown experiment '{exp}'")
        exp_cfg = _compose_file(
            config_dir, os.path.relpath(epath, config_dir), "experiment",
            selections,
        )

    # re-select groups requested by experiment overrides or the CLI
    selections.update(group_sel)
    for group, option in selections.items():
        opath = _option_path(config_dir, group, str(option))
        if not os.path.exists(opath):
            raise ConfigError(f"missing config {opath} for group '{group}'")
        sub = _compose_file(
            config_dir, os.path.relpath(opath, config_dir), group, {}
        )
        if _is_global_package(opath):
            cfg = _deep_merge(cfg, sub)
        else:
            cfg[group.split("/")[-1]] = sub

    if exp_cfg:
        cfg = _deep_merge(cfg, exp_cfg)

    for key, val in value_overrides:
        _set_dotted(cfg, key, _parse_value(val))
    for key in deletions:
        _del_dotted(cfg, key)

    # interpolate to a fixed point: chained references
    # (output_dir -> log_dir -> root_dir -> env) resolve in successive passes
    for _ in range(10):
        new_cfg = _interpolate(cfg, cfg, [])
        if new_cfg == cfg:
            break
        cfg = new_cfg
    return cfg
