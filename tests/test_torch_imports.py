"""gcpnet_torch and chip_smoke.py import nothing of JAX, flax or gcpnet_tpu:
every module of the package, the chip scripts (``chip_smoke.py``,
``k1_versions.py``, ``k2_versions.py``, ``k2_breakdown.py``, ``k3_breakdown.py``,
``hopper_turns.py``), the card's
tests (``test_torch_gpu.py``, which run where JAX is absent), a CPU
prediction, a CPU LBA training run, a CPU NMS fit with its simulated data,
the external scorers and the AMBER modules,
a CPU RS fit on synthetic enantiomers (and one of E(3) RS on GCP v1 with
the sigma frame gate, composed from ``experiment=gcpnet_rs_ablations``), a
CPU PSR fit on synthetic ATOM3D
records, a CPU CPD fit with its design metrics on synthetic CATH chains, a
CPU EQ fit on synthetic decoys with the config-driven prediction of its
decoys, a CPU AR fit on synthetic pairs with its refinement of their decoys
(``python -m gcpnet_torch.train [--task nms|rs|psr|cpd|eq|ar]``, ``python -m
gcpnet_torch.predict``, ``python -m gcpnet_torch.predict_ar``), and the
config-driven train and eval entry points on NMS (``python -m
gcpnet_torch.train experiment=...``, ``python -m gcpnet_torch.eval``) in a
fresh interpreter whose import system refuses those packages."""

import subprocess
import sys
from pathlib import Path

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)

REPO = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib.abc, importlib.util, pkgutil, runpy, sys

BLOCKED = ("jax", "jaxlib", "flax", "gcpnet_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())

import gcpnet_torch

# __main__ modules run their program when imported: run below instead
names = [
    m.name for m in pkgutil.walk_packages(gcpnet_torch.__path__, "gcpnet_torch.")
    if not m.name.endswith(".__main__")
]
for name in names:
    importlib.import_module(name)
for name, path in (("chip_smoke", "chip_smoke.py"), ("test_torch_gpu", "tests/test_torch_gpu.py"),
                   ("k1_versions", "k1_versions.py"), ("k2_versions", "k2_versions.py"),
                   ("k2_breakdown", "k2_breakdown.py"), ("k3_breakdown", "k3_breakdown.py"),
                   ("hopper_turns", "hopper_turns.py")):
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))

from gcpnet_torch.predict import main

main(["--graphs", "1", "--nodes", "8", "--edges-per-node", "4", "--device", "cpu"])
sys.argv = ["gcpnet_torch.train", "--steps", "1", "--graphs", "1", "--nodes", "8",
            "--edges-per-node", "4", "--device", "cpu"]
runpy.run_module("gcpnet_torch.train", run_name="__main__")
import tempfile

with tempfile.TemporaryDirectory() as root:
    sys.argv = ["gcpnet_torch.train", "--task", "nms", "--device", "cpu", "--data-mode", "small",
                "--num-train", "4", "--num-valid", "2", "--num-test", "2", "--batch-size", "2",
                "--num-encoder-layers", "1", "--max-epochs", "1", "--min-epochs", "0",
                "--data-root", root + "/data", "--checkpoint-dir", root + "/ckpt"]
    runpy.run_module("gcpnet_torch.train", run_name="__main__")
with tempfile.TemporaryDirectory() as root:
    # the config-driven train and eval entry points
    tiny = ["experiment=gcpnet_nms_small", "trainer.accelerator=cpu", "datamodule.num_train=4",
            "datamodule.num_valid=2", "datamodule.num_test=2", "datamodule.batch_size=2",
            "datamodule.data_dir=" + root + "/data", "model.model_cfg.num_encoder_layers=1",
            "paths.output_dir=" + root + "/run", "trainer.max_epochs=1", "extras.print_config=false"]
    sys.argv = ["gcpnet_torch.train", *tiny]
    runpy.run_module("gcpnet_torch.train", run_name="__main__")
    sys.argv = ["gcpnet_torch.eval", *tiny, "ckpt_path=" + root + "/run/checkpoints"]
    runpy.run_module("gcpnet_torch.eval", run_name="__main__")
sys.argv = ["gcpnet_torch.train", "--task", "rs", "--device", "cpu", "--num-train", "8", "--num-valid", "4",
            "--num-test", "4", "--batch-size", "2", "--num-encoder-layers", "1", "--max-epochs", "1",
            "--min-epochs", "0"]
runpy.run_module("gcpnet_torch.train", run_name="__main__")
with tempfile.TemporaryDirectory() as root:
    # the rest of the GCP family through the config-driven entry point: RS
    # in E(3) mode on GCP v1 with the sigma frame gate
    sys.argv = ["gcpnet_torch.train", "experiment=gcpnet_rs_ablations", "trainer.accelerator=cpu",
                "+datamodule.synthetic_sizes={train: 8, valid: 4, test: 4}", "datamodule.batch_size=2",
                "model.model_cfg.num_encoder_layers=1", "trainer.max_epochs=1", "paths.output_dir=" + root,
                "extras.print_config=false", "model.module_cfg.enable_e3_equivariance=true",
                "model.module_cfg.selected_GCP._target_=gcpnet_tpu.nn.gcp.GCP",
                "model.module_cfg.sigma_frame_gate=true", "model.module_cfg.vector_gate=false"]
    runpy.run_module("gcpnet_torch.train", run_name="__main__")
import functools

from chip_smoke import write_psr_records
from gcpnet_torch.data import atom3d, registry

with tempfile.TemporaryDirectory() as root:
    write_psr_records(root, targets={"train": 2, "val": 1, "test": 1}, decoys=3, atoms=(20, 40))
    # the entry point with a bucket of 128 nodes (the JAX one's 16,384 take
    # minutes a step on the CPU)
    registry.DATAMODULES["ATOM3DDataModule"] = functools.partial(atom3d.ATOM3DDataModule, max_nodes_per_batch=128)
    sys.argv = ["gcpnet_torch.train", "--task", "psr", "--device", "cpu", "--data-dir", root, "--batch-size", "3",
                "--num-encoder-layers", "1", "--max-epochs", "1", "--min-epochs", "0"]
    runpy.run_module("gcpnet_torch.train", run_name="__main__")
from gcpnet_torch.data import cath
from gcpnet_torch.data.cath_synthetic import write_cath_chains

with tempfile.TemporaryDirectory() as root:
    write_cath_chains(root, chains={"train": 3, "validation": 2, "test": 2}, lengths=(20, 40))
    registry.DATAMODULES["CATHDataModule"] = functools.partial(cath.CATHDataModule, max_nodes_per_batch=128)
    sys.argv = ["gcpnet_torch.train", "--task", "cpd", "--device", "cpu", "--data-dir", root, "--batch-size", "2",
                "--num-encoder-layers", "1", "--max-epochs", "1", "--min-epochs", "0", "--num-samples", "2"]
    runpy.run_module("gcpnet_torch.train", run_name="__main__")
from gcpnet_torch.data import eq
from gcpnet_torch.data.eq_synthetic import write_eq_decoys

with tempfile.TemporaryDirectory() as root:
    write_eq_decoys(root, targets={"train": 2, "valid": 1, "test": 1}, decoys=1, residues=(10, 20))
    registry.DATAMODULES["EQDataModule"] = functools.partial(
        eq.EQDataModule, max_nodes_per_batch=256, max_residues_per_batch=32
    )
    sys.argv = ["gcpnet_torch.train", "--task", "eq", "--device", "cpu", "--data-dir", root,
                "--num-encoder-layers", "1", "--max-epochs", "1", "--min-epochs", "0", "--checkpoint-dir", root + "/ckpt"]
    runpy.run_module("gcpnet_torch.train", run_name="__main__")
    # the config-driven prediction entry point on the EQ checkpoint
    sys.argv = ["gcpnet_torch.predict", "model=gcpnet_eq", "datamodule=eq", "trainer.accelerator=cpu",
                "model.model_cfg.num_encoder_layers=1", "ckpt_path=" + root + "/ckpt",
                "datamodule.predict_input_dir=" + root + "/decoy_model", "datamodule.predict_output_dir=" + root + "/out",
                "paths.output_dir=" + root + "/run", "extras.print_config=false"]
    runpy.run_module("gcpnet_torch.predict", run_name="__main__")
from gcpnet_torch.data import ar
from gcpnet_torch.data.ar_synthetic import write_ar_pairs

with tempfile.TemporaryDirectory() as root:
    write_ar_pairs(root, pairs={"train": 2, "valid": 1, "test": 1}, train_residues=(10, 20), eval_residues=(10, 20))
    registry.DATAMODULES["ARDataModule"] = lambda **kw: ar.ARDataModule(
        **{**kw, "k_max": 16, "max_nodes_per_batch": 256, "max_residues_per_batch": 32}
    )
    sys.argv = ["gcpnet_torch.train", "--task", "ar", "--device", "cpu", "--data-dir", root,
                "--num-encoder-layers", "1", "--max-epochs", "1", "--min-epochs", "0", "--checkpoint-dir", root + "/ckpt"]
    runpy.run_module("gcpnet_torch.train", run_name="__main__")
    sys.argv = ["gcpnet_torch.predict_ar", "--input-dir", root + "/AF2_model", "--true-dir", root + "/true_model",
                "--output-dir", root + "/refined", "--checkpoint-dir", root + "/ckpt", "--num-encoder-layers", "1",
                "--k-max", "16", "--max-nodes-per-batch", "256", "--max-residues-per-batch", "32", "--device", "cpu"]
    runpy.run_module("gcpnet_torch.predict_ar", run_name="__main__")
for name in ("gcpnet_torch.data.atom3d", "gcpnet_torch.data.cath", "gcpnet_torch.data.cath_synthetic",
             "gcpnet_torch.data.protein_graph",
             "gcpnet_torch.models.cpd", "gcpnet_torch.models.cpd_eval", "gcpnet_torch.nn.decoder",
             "gcpnet_torch.data.eq", "gcpnet_torch.data.eq_synthetic", "gcpnet_torch.data.esm",
             "gcpnet_torch.data.pdb", "gcpnet_torch.models.eq", "gcpnet_torch.utils.structure_metrics",
             "gcpnet_torch.data.ar", "gcpnet_torch.data.ar_synthetic", "gcpnet_torch.models.ar",
             "gcpnet_torch.predict_ar", "gcpnet_torch.config.loader", "gcpnet_torch.config.instantiate",
             "gcpnet_torch.data.registry", "gcpnet_torch.utils.pylogger", "gcpnet_torch.utils.utils",
             "gcpnet_torch.utils.loggers", "gcpnet_torch.utils.sweeps", "gcpnet_torch.train.entry",
             "gcpnet_torch.eval", "gcpnet_torch.utils.torch_compat", "gcpnet_torch.utils.external_tools",
             "gcpnet_torch.utils.amber", "gcpnet_torch.utils.amber.cleanup", "gcpnet_torch.utils.amber.violations",
             "gcpnet_torch.utils.amber.relax"):
    assert name in names, name
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("modules", len(names))
"""


def test_port_imports_no_jax_flax_or_reference():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules = int(proc.stdout.split("modules")[-1])
    assert n_modules >= 20
