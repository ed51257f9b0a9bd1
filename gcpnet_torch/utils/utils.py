"""Cross-cutting run utilities: the port's copy of
``gcpnet_tpu/utils/utils.py`` (``extras``, the config tree's printout,
``task_wrapper`` with its exec-time log, the optimized metric's value, a
signal-based time limit and the grid search's halt file).
"""

from __future__ import annotations

import contextlib
import functools
import os
import signal
import threading
import time
import warnings
from typing import Any, Callable, Dict, Optional

from gcpnet_torch.utils.pylogger import get_pylogger

log = get_pylogger(__name__)


def extras(cfg: Dict[str, Any]) -> None:
    """Apply the ``extras:`` options before the task starts
    (reference utils.py:67-103)."""
    ex = cfg.get("extras") or {}
    if ex.get("ignore_warnings"):
        warnings.filterwarnings("ignore")
    if ex.get("enforce_tags") and not cfg.get("tags"):
        log.warning("no tags provided — continuing with tags=['dev']")
        cfg["tags"] = ["dev"]
    if ex.get("print_config", True):
        print_config_tree(cfg)


def print_config_tree(cfg: Dict[str, Any], indent: int = 0) -> None:
    """Plain-text config tree (the reference pretty-prints with Rich,
    rich_utils.py:21-109)."""
    if indent == 0:
        log.info("composed config:")
    pad = "  " * indent
    for key, value in cfg.items():
        if isinstance(value, dict):
            print(f"{pad}{key}:")
            print_config_tree(value, indent + 1)
        else:
            print(f"{pad}{key}: {value}")


def task_wrapper(task_func: Callable) -> Callable:
    """Wraps a task entry: applies extras, logs exceptions and wall-clock
    time to ``exec_time.log`` (reference utils.py:29-64)."""

    @functools.wraps(task_func)
    def wrap(cfg: Dict[str, Any], *args, **kwargs):
        extras(cfg)
        start = time.time()
        try:
            result = task_func(cfg, *args, **kwargs)
        except Exception:
            log.exception("task raised an exception")
            raise
        finally:
            out_dir = (cfg.get("paths") or {}).get("output_dir") or "."
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "exec_time.log"), "a") as f:
                f.write(
                    f"'{cfg.get('task_name', 'task')}' execution time: "
                    f"{time.time() - start:.2f} (s)\n"
                )
        return result

    return wrap


def get_metric_value(
    metric_dict: Dict[str, Any], metric_name: Optional[str]
) -> Optional[float]:
    """Fetch the optimized metric for hyperparameter sweeps
    (reference utils.py:186-203)."""
    if not metric_name:
        return None
    if metric_name not in metric_dict:
        raise KeyError(
            f"metric '{metric_name}' not found in {sorted(metric_dict)}"
        )
    return float(metric_dict[metric_name])


class TimeoutException(Exception):
    pass


@contextlib.contextmanager
def time_limit(seconds: int):
    """Signal-alarm timeout guard for hanging host-side work such as PDB
    parsing (reference utils.py:219-233).

    SIGALRM can only be armed from the main thread; when called from a
    worker (e.g. the Trainer's host->device prefetch thread) this degrades
    to a no-op guard instead of raising ``ValueError: signal only works in
    main thread``, which would drop every example."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def handler(signum, frame):
        raise TimeoutException("timed out")

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


HALT_FILE_EXTENSION = "done"


def write_halt_file(cfg: Dict[str, Any], run_id: str) -> None:
    """Grid-search completion marker (reference gcpnet_*_module.on_fit_end,
    e.g. gcpnet_lba_module.py:310-324)."""
    paths = cfg.get("paths") or {}
    script_dir = paths.get("grid_search_script_dir")
    if not script_dir:
        return
    os.makedirs(script_dir, exist_ok=True)
    path = os.path.join(script_dir, f"{run_id}.{HALT_FILE_EXTENSION}")
    with open(path, "w") as f:
        f.write("`on_fit_end` has been called.")
