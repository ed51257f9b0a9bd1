"""Process-zero logging: the port's copy of ``gcpnet_tpu/utils/pylogger.py``,
with the rank of ``torch.distributed`` (0 without a process group) in place
of the JAX process index."""

from __future__ import annotations

import logging

import torch


def _is_main_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class _RankZeroFilter(logging.Filter):
    def filter(self, record):
        return _is_main_process()


def get_pylogger(name: str = __name__) -> logging.Logger:
    """A logger that writes on process 0 only, to standard error."""
    logger = logging.getLogger(name)
    if not any(isinstance(f, _RankZeroFilter) for f in logger.filters):
        logger.addFilter(_RankZeroFilter())
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
