"""Hyperparameter search: the port's copy of ``gcpnet_tpu/utils/sweeps.py``.

The search-space grammar of ``configs/hparams_search/*.yaml``
(``interval(lo, hi)``, log-uniform for positive ranges spanning 10x or
more, ``choice(a, b, ...)``, ``range(lo, hi, step)``) drives Optuna where it
is importable, else a seeded random sampler.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from gcpnet_torch.utils.pylogger import get_pylogger

log = get_pylogger(__name__)

_INTERVAL = re.compile(r"interval\(\s*([^,]+)\s*,\s*([^)]+)\s*\)")
_CHOICE = re.compile(r"choice\((.*)\)")
_RANGE = re.compile(r"range\(\s*([^,]+)\s*,\s*([^,)]+)\s*(?:,\s*([^)]+))?\)")


def parse_space(params: Dict[str, str]) -> Dict[str, Tuple[str, Any]]:
    space = {}
    for key, spec in params.items():
        spec = str(spec)
        m = _INTERVAL.fullmatch(spec)
        if m:
            lo, hi = float(m.group(1)), float(m.group(2))
            space[key] = ("interval", (lo, hi))
            continue
        m = _CHOICE.fullmatch(spec)
        if m:
            opts = [_parse_scalar(tok) for tok in m.group(1).split(",")]
            space[key] = ("choice", opts)
            continue
        m = _RANGE.fullmatch(spec)
        if m:
            lo, hi = float(m.group(1)), float(m.group(2))
            step = float(m.group(3)) if m.group(3) else 1.0
            space[key] = ("choice", list(np.arange(lo, hi, step)))
            continue
        raise ValueError(f"unsupported search spec {spec!r} for {key}")
    return space


def _parse_scalar(tok: str):
    tok = tok.strip()
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    if tok.lower() in ("true", "false"):
        return tok.lower() == "true"
    return tok


def _sample(space, rng: np.random.Generator) -> Dict[str, Any]:
    out = {}
    for key, (kind, arg) in space.items():
        if kind == "interval":
            lo, hi = arg
            if lo > 0 and hi / lo >= 10:
                out[key] = float(
                    math.exp(rng.uniform(math.log(lo), math.log(hi)))
                )
            else:
                out[key] = float(rng.uniform(lo, hi))
        else:
            out[key] = arg[int(rng.integers(len(arg)))]
    return out


def run_search(
    objective: Callable[[Dict[str, Any]], float],
    params: Dict[str, str],
    n_trials: int = 25,
    direction: str = "minimize",
    seed: int = 1234,
) -> Tuple[Dict[str, Any], float, List[Dict]]:
    """Returns (best_params, best_value, all_trials)."""
    space = parse_space(params)
    trials: List[Dict] = []

    try:
        import optuna  # noqa: F401

        return _run_optuna(objective, space, n_trials, direction, seed)
    except ImportError:
        pass

    rng = np.random.default_rng(seed)
    best_params, best_value = None, None
    sign = 1.0 if direction == "minimize" else -1.0
    for t in range(n_trials):
        candidate = _sample(space, rng)
        value = objective(candidate)
        trials.append({"params": candidate, "value": value})
        log.info(f"trial {t}: {candidate} -> {value}")
        if value is not None and (
            best_value is None or sign * value < sign * best_value
        ):
            best_params, best_value = candidate, value
    return best_params, best_value, trials


def _run_optuna(objective, space, n_trials, direction, seed):
    import optuna

    def optuna_objective(trial):
        candidate = {}
        for key, (kind, arg) in space.items():
            if kind == "interval":
                lo, hi = arg
                log_scale = lo > 0 and hi / lo >= 10
                candidate[key] = trial.suggest_float(key, lo, hi, log=log_scale)
            else:
                candidate[key] = trial.suggest_categorical(key, arg)
        return objective(candidate)

    study = optuna.create_study(
        direction=direction,
        sampler=optuna.samplers.TPESampler(seed=seed),
    )
    study.optimize(optuna_objective, n_trials=n_trials)
    trials = [
        {"params": t.params, "value": t.value} for t in study.trials
    ]
    return study.best_params, study.best_value, trials
