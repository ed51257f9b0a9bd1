"""The evaluation entry point: ``python -m gcpnet_torch.eval <overrides>
ckpt_path=<checkpoint dir>``, the port of the root ``eval.py``.

It composes ``configs/eval.yaml`` (the JAX entry point's grammar, as
``gcpnet_torch.train``), builds the datamodule, the model and the Trainer
from the composed blocks, restores the best checkpoint of ``ckpt_path`` by
``val/loss`` (else its last) and runs the test loop.  For CPD it adds the
design metrics of the test chains (``models.cpd_eval.evaluate_cpd``,
``cpd_num_samples`` sequences a chain, 100 by default; recovery only with
the autoregressive decoder).  It runs on the card unless
``trainer.accelerator=cpu``::

    python -m gcpnet_torch.eval experiment=gcpnet_lba ckpt_path=logs/train/runs/checkpoints
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Sequence

from gcpnet_torch import tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.train.entry import build_trainer, restore, setup
from gcpnet_torch.utils.pylogger import get_pylogger
from gcpnet_torch.utils.utils import task_wrapper

log = get_pylogger(__name__)


@task_wrapper
def evaluate(cfg: Dict[str, Any]):
    """The test metrics of ``ckpt_path``'s best (else last) checkpoint, and
    the Trainer."""
    ckpt_path = cfg.get("ckpt_path")
    if not ckpt_path or ckpt_path == "???":
        raise ValueError("eval requires ckpt_path=<checkpoint dir>")
    _, datamodule, model, model_name = setup(cfg)
    trainer = build_trainer(cfg, model, tasks.build_loss(model_name), model_name, checkpoints=False)
    log.info(f"evaluating step {restore(trainer, ckpt_path, best=True)} of {ckpt_path}")
    metrics = trainer.test(datamodule)
    if model_name == "GCPNetCPD":
        from gcpnet_torch.models.cpd_eval import evaluate_cpd

        cpd = evaluate_cpd(
            trainer.model, datamodule.named_graphs("test"), custom_splits=datamodule.custom_splits,
            num_samples=int(cfg.get("cpd_num_samples", 100)), max_nodes=datamodule.max_nodes_per_batch,
            compute_recovery=bool((cfg.get("model") or {}).get("autoregressive_decoder", False)),
        )
        metrics.update(cpd)
        log.info(f"CPD metrics: {cpd}")
    return metrics, trainer


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    cfg = compose(CONFIG_DIR, "eval.yaml", list(sys.argv[1:] if argv is None else argv))
    metrics, _ = evaluate(cfg)
    return metrics


if __name__ == "__main__":
    main()
