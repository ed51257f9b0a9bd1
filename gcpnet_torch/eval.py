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

``trainer.devices=N`` evaluates on N devices of this machine, as training
does (``gcpnet_torch.train``): N processes, each testing its shard of every
global batch (the JAX entry point's ``dp`` mesh), with the losses averaged
and the predictions gathered, so every process reports the metrics over
all the batches; CPD's design metrics run on rank 0 alone.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Sequence

from gcpnet_torch import parallel, tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.train.entry import build_trainer, launch_devices, restore, setup
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
    _, datamodule, model, model_name, group = setup(cfg)
    trainer = build_trainer(cfg, model, tasks.build_loss(model_name), model_name, checkpoints=False, group=group)
    log.info(f"evaluating step {restore(trainer, ckpt_path, best=True)} of {ckpt_path}")
    metrics = trainer.test(datamodule)
    if model_name == "GCPNetCPD" and trainer.is_main:
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
    """The test metrics of the overrides ``argv``; with ``trainer.devices``
    above 1 and no launcher, rank 0's of the processes this starts."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = compose(CONFIG_DIR, "eval.yaml", argv)
    devices = launch_devices(cfg)
    if devices > 1:
        return parallel.launch(main, devices, argv)
    metrics, _ = evaluate(cfg)
    return metrics


if __name__ == "__main__":
    main()
