"""The config-driven training entry point: ``python -m gcpnet_torch.train
<overrides>``, the port of the root ``train.py``.

It composes ``configs/train.yaml`` with the JAX entry point's grammar
(``gcpnet_torch.config.loader``): the ``experiment=`` package, group
selection, ``key=value``, ``+key=value`` and ``~key`` overrides and the
``${...}`` interpolations; builds the datamodule, the model and the
:class:`~gcpnet_torch.train.trainer.Trainer` from the composed blocks, fits,
and tests the best checkpoint::

    python -m gcpnet_torch.train experiment=gcpnet_lba trainer.max_epochs=100
    python -m gcpnet_torch.train -m experiment=gcpnet_lba seed=1,2        (multirun)
    python -m gcpnet_torch.train -m hparams_search=nms_optuna experiment=gcpnet_nms_small

``trainer.accelerator=cpu`` runs on the CPU through the kernels' plain
versions; any other value (``tpu``, the default of
``configs/trainer/default.yaml``, ``gpu``, ``auto``) runs on the CUDA card
and raises where there is none.

``trainer.devices=N`` trains data-parallel on N devices of this machine
(``-1``/``auto``: every GPU; on the CPU, N gloo processes): unless a
launcher already started this process, ``main`` starts N processes
(``parallel.launch``), each running the same overrides on its own GPU and
shard, and returns rank 0's metrics; under ``torchrun --nproc-per-node N``
each process joins the launcher's group instead.  ``trainer.num_nodes``
above 1 runs only under such an external launcher, as the JAX entry point
leaves it to ``jax.distributed``.  One deliberate difference: ``devices``
above the GPUs present (or the CPU's cores) raises, where the JAX entry
point quietly takes the devices there are.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gcpnet_torch import parallel, tasks
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.data.batching import Shards
from gcpnet_torch.data.registry import build_datamodule
from gcpnet_torch.train.checkpoints import CheckpointManager
from gcpnet_torch.train.trainer import Trainer
from gcpnet_torch.utils.loggers import instantiate_loggers
from gcpnet_torch.utils.pylogger import get_pylogger
from gcpnet_torch.utils.utils import get_metric_value, task_wrapper, write_halt_file

log = get_pylogger(__name__)


def _on_cpu(trainer_cfg: Dict[str, Any]) -> bool:
    return str(trainer_cfg.get("accelerator", "tpu")).lower() == "cpu"


def world_of(trainer_cfg: Dict[str, Any]) -> Tuple[int, int]:
    """``(devices a machine, machines)`` of ``trainer.devices`` and
    ``trainer.num_nodes``; ``devices`` ``-1``/``auto`` is every GPU (one
    process on the CPU).  More devices than this machine has raise."""
    devices = trainer_cfg.get("devices", 1)
    nodes = int(trainer_cfg.get("num_nodes", 1) or 1)
    cpu = _on_cpu(trainer_cfg)
    present = (os.cpu_count() or 1) if cpu else torch.cuda.device_count()
    if str(devices) in ("-1", "auto", "None"):
        return (1 if cpu else max(1, present)), nodes
    n = int(devices)
    if n < 1 or (n > 1 and n > present):
        raise ValueError(
            f"trainer.devices={n}, but this machine has {present} {'CPU cores' if cpu else 'GPUs'} "
            "(the JAX entry point would take fewer devices without a word; the port refuses)"
        )
    return n, nodes


def device_of(trainer_cfg: Dict[str, Any]) -> torch.device:
    """This process's device of ``trainer.accelerator``: the CPU for
    ``cpu``, else the CUDA card (``cuda:<LOCAL_RANK>`` under a launcher),
    which must be there."""
    world_of(trainer_cfg)
    if _on_cpu(trainer_cfg):
        return torch.device("cpu")
    accelerator = trainer_cfg.get("accelerator", "tpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"trainer.accelerator={accelerator} runs on the CUDA card and none is available; "
            "set trainer.accelerator=cpu (device='cpu') to run the plain-PyTorch path"
        )
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if parallel.launched() else torch.device("cuda")


def group_of(trainer_cfg: Dict[str, Any], device: torch.device) -> Optional[parallel.Group]:
    """The data-parallel group this process joins, when a launcher started
    it (its world must be ``devices x num_nodes``); else ``None``."""
    if not parallel.launched():
        return None
    devices, nodes = world_of(trainer_cfg)
    if int(os.environ["WORLD_SIZE"]) != devices * nodes:
        raise ValueError(
            f"the launcher started {os.environ['WORLD_SIZE']} processes, but trainer.devices={devices} "
            f"x trainer.num_nodes={nodes} asks for {devices * nodes}"
        )
    return parallel.init_from_env(device.type, nodes=nodes)


def launch_devices(cfg: Dict[str, Any]) -> int:
    """How many processes an entry point starts for the composed ``cfg``:
    ``trainer.devices`` of this machine, or 1 where a launcher started this
    process (it is one of them).  ``trainer.num_nodes`` above 1 raises
    without such a launcher."""
    if parallel.launched():
        return 1
    devices, nodes = world_of(cfg.get("trainer") or {})
    if nodes > 1:
        raise ValueError(
            f"trainer.num_nodes={nodes} runs under an external launcher (torchrun --nnodes {nodes} "
            f"--nproc-per-node {devices} -m gcpnet_torch.train ...), which sets RANK and WORLD_SIZE"
        )
    return devices


def single_device(cfg: Dict[str, Any], what: str) -> None:
    """``what`` (prediction) runs on one device: more raise."""
    if world_of(cfg.get("trainer") or {}) != (1, 1) or parallel.launched():
        raise ValueError(f"{what} runs on one device: set trainer.devices=1 and trainer.num_nodes=1")


def build_trainer(cfg: Dict[str, Any], model, loss_fn, model_name: str, checkpoints: bool = True,
                  loggers: Sequence = (), group: Optional[parallel.Group] = None) -> Trainer:
    """The Trainer of the composed ``trainer``, ``callbacks`` and ``model``
    blocks, as the JAX ``build_trainer`` makes it; ``checkpoints=False``
    writes none (evaluation and prediction).  In a data-parallel ``group``
    only rank 0 has loggers."""
    trainer_cfg = cfg.get("trainer") or {}
    callbacks = cfg.get("callbacks") or {}
    ckpt_cb = callbacks.get("model_checkpoint") or {}
    es_cb = callbacks.get("early_stopping") or {}
    model_block = cfg.get("model") or {}
    opt_cfg = dict(model_block.get("optimizer") or {"_target_": "Adam", "lr": 1e-4})
    opt_cfg["accumulate_grad_batches"] = trainer_cfg.get("accumulate_grad_batches", 1)

    fast_dev_run = bool(trainer_cfg.get("fast_dev_run", False))
    max_steps = 1 if fast_dev_run else None
    limit = trainer_cfg.get("limit_train_batches")
    if limit and not fast_dev_run:
        max_steps = max(1, int(float(limit))) if float(limit) >= 1 else None

    output_dir = (cfg.get("paths") or {}).get("output_dir") or "logs/run"
    ckpt_dir = None
    if checkpoints and cfg.get("train", True) and not fast_dev_run:
        ckpt_dir = ckpt_cb.get("dirpath") or os.path.join(output_dir, "checkpoints")
    module_cfg = model_block.get("module_cfg") or {}
    n_step = (callbacks.get("n_step_model_checkpoint") or {}).get("save_frequency")
    return Trainer(
        model,
        loss_fn,
        optimizer_cfg=opt_cfg,
        scheduler_cfg=model_block.get("scheduler") or None,
        max_epochs=1 if fast_dev_run else int(trainer_cfg.get("max_epochs", 1)),
        min_epochs=0 if fast_dev_run else int(trainer_cfg.get("min_epochs", 0)),
        adaptive_clip=bool(module_cfg.get("clip_gradients", False)),
        checkpoint_dir=ckpt_dir,
        monitor=ckpt_cb.get("monitor", "val/loss"),
        monitor_mode=ckpt_cb.get("mode", "min"),
        early_stopping_patience=es_cb.get("patience", 10) if es_cb else None,
        save_top_k=int(ckpt_cb.get("save_top_k", 30) or 30),
        seed=int(cfg.get("seed", 42)),
        collect_fn=tasks.build_collect(model_name),
        metric_fns=tasks.build_metric_fns(model_name),
        log_dir=output_dir,
        max_steps_per_epoch=max_steps,
        check_val_every_n_epoch=int(trainer_cfg.get("check_val_every_n_epoch", 1)),
        loggers=[*instantiate_loggers(cfg.get("logger")), *loggers] if group is None or group.is_main else [],
        precision=int(trainer_cfg.get("precision", 32) or 32),
        scan_chunk_size=int(trainer_cfg.get("scan_chunk_size", 1) or 1),
        checkpoint_every_n_steps=int(n_step) if n_step else None,
        group=group,
    )


def setup(cfg: Dict[str, Any], stage: Optional[str] = None):
    """The device, the datamodule (prepared and set up; this process's
    shard of each batch) and the model with its registry name, of a
    composed config, and the data-parallel group (``None`` alone)."""
    seed = int(cfg.get("seed", 42))
    np.random.seed(seed)
    trainer_cfg = cfg.get("trainer") or {}
    device = device_of(trainer_cfg)
    group = group_of(trainer_cfg, device)
    shards = group.shards if group is not None else Shards()
    if group is None or group.is_main:
        datamodule = build_datamodule(cfg["datamodule"], seed=seed, device=device, shards=shards)
        datamodule.prepare_data()
    # rank 0 prepares (simulates, writes caches) before the others read
    parallel.barrier(group)
    if group is not None and not group.is_main:
        datamodule = build_datamodule(cfg["datamodule"], seed=seed, device=device, shards=shards)
        datamodule.prepare_data()
    datamodule.setup() if stage is None else datamodule.setup(stage=stage)
    model, model_name = tasks.build_model(cfg["model"], seed=seed, device=device)
    return device, datamodule, model, model_name, group


def restore(trainer: Trainer, ckpt_path: str, best: bool) -> int:
    """Load the checkpoint of ``ckpt_path`` (the best by ``val/loss`` where
    ``best`` and there is one, else the last) into ``trainer``; its step."""
    mgr = CheckpointManager(ckpt_path, monitor="val/loss")
    state = (mgr.restore_best(map_location=trainer.device) if best else None) or mgr.restore_last(
        map_location=trainer.device
    )
    if state is None:
        raise FileNotFoundError(f"no checkpoint found under {ckpt_path}")
    trainer.load_checkpoint_state(state)
    return state["step"]


@contextlib.contextmanager
def _profiled(trainer_cfg: Dict[str, Any], device: torch.device):
    """``trainer.profiler``: a torch.profiler trace of the fit, written to
    ``trainer.profiler_trace_dir/trace.json``."""
    if not trainer_cfg.get("profiler"):
        yield
        return
    trace_dir = trainer_cfg.get("profiler_trace_dir")
    if not trace_dir:
        raise ValueError(f"trainer.profiler={trainer_cfg['profiler']} needs trainer.profiler_trace_dir")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@task_wrapper
def train(cfg: Dict[str, Any], loggers: Sequence = ()) -> Tuple[Dict[str, float], Trainer, Any]:
    """Fit (unless ``train=false``), then test the best checkpoint (unless
    ``test=false``); ``ckpt_path`` resumes from that directory's last
    checkpoint.  The metrics, the Trainer and the datamodule."""
    device, datamodule, model, model_name, group = setup(cfg)
    trainer = build_trainer(cfg, model, tasks.build_loss(model_name), model_name, loggers=loggers, group=group)
    seed = int(cfg.get("seed", 42))
    for lg in trainer.loggers:
        if hasattr(lg, "log_hyperparams"):
            lg.log_hyperparams({k: cfg.get(k) for k in ("model", "datamodule", "trainer", "tags")} | {"seed": seed})
    if cfg.get("ckpt_path"):
        log.info(f"resuming from step {restore(trainer, cfg['ckpt_path'], best=False)} of {cfg['ckpt_path']}")
    metrics: Dict[str, float] = {}
    if cfg.get("train", True):
        with _profiled(cfg.get("trainer") or {}, device):
            metrics.update(trainer.fit(datamodule))
        if trainer.is_main:
            write_halt_file(cfg, run_id=f"{cfg.get('task_name', 'train')}_{seed}")
    if cfg.get("test", True):
        best = trainer.restore_best()
        if best is not None:
            log.info(f"testing with the best checkpoint (step {best})")
        metrics.update(trainer.test(datamodule))
    for lg in trainer.loggers:
        if hasattr(lg, "finalize"):
            lg.finalize()
    return metrics, trainer, datamodule


def _runs(argv: List[str]) -> List[List[str]]:
    """A multirun's override lists: the cartesian product of its
    comma-separated values."""
    keys, options, fixed = [], [], []
    for ov in argv:
        if "=" in ov and "," in ov.split("=", 1)[1]:
            key, value = ov.split("=", 1)
            keys.append(key)
            options.append(value.split(","))
        else:
            fixed.append(ov)
    return [fixed + [f"{k}={v}" for k, v in zip(keys, combo)] for combo in itertools.product(*options)]


def main(argv: Optional[Sequence[str]] = None, loggers: Sequence = (), trainers: Optional[list] = None):
    """Run the overrides ``argv``: the metrics (a list of them for a
    multirun; the best parameters and value for ``-m hparams_search=``).
    ``loggers`` are added to each run's Trainer, which goes to ``trainers``
    where that is a list.  With ``trainer.devices`` above 1 and no
    launcher, this starts a process a device, each running ``argv``, and
    returns rank 0's result (``loggers`` and ``trainers`` stay in this
    process, so they must be empty then)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    devices = launch_devices(compose(CONFIG_DIR, "train.yaml", [ov for ov in argv if ov not in ("-m", "--multirun")]))
    if devices > 1:
        if loggers or trainers is not None:
            raise ValueError("main: loggers and trainers stay in this process; a data-parallel run takes neither")
        return parallel.launch(main, devices, argv)
    multirun = any(flag in argv for flag in ("-m", "--multirun"))
    argv = [ov for ov in argv if ov not in ("-m", "--multirun")]

    def run(cfg):
        metrics, trainer, _ = train(cfg, loggers=loggers)
        if trainers is not None:
            trainers.append(trainer)
        return metrics

    if multirun and any(ov.startswith("hparams_search=") for ov in argv):
        from gcpnet_torch.utils.sweeps import run_search

        cfg = compose(CONFIG_DIR, "train.yaml", argv)
        hs = cfg.get("hparams_search") or {}
        fixed = [ov for ov in argv if not ov.startswith("hparams_search=")]

        def objective(params):
            trial = compose(CONFIG_DIR, "train.yaml", fixed + [f"{k}={v}" for k, v in params.items()])
            return run(trial).get(cfg.get("optimized_metric", "val/loss"))

        best_params, best_value, _ = run_search(
            objective, hs.get("params", {}), n_trials=int(hs.get("n_trials", 25)),
            direction=hs.get("direction", "minimize"), seed=int(hs.get("sampler_seed", 1234)),
        )
        log.info(f"best: {best_params} -> {best_value}")
        return {"best_params": best_params, "best_value": best_value}
    if multirun:
        results = []
        for overrides in _runs(argv):
            log.info(f"multirun: {overrides}")
            results.append(run(compose(CONFIG_DIR, "train.yaml", overrides)))
        return results
    cfg = compose(CONFIG_DIR, "train.yaml", argv)
    metrics = run(cfg)
    value = get_metric_value(metrics, cfg.get("optimized_metric"))
    if value is not None:
        print(f"optimized_metric {cfg['optimized_metric']}={value}")
    return metrics

