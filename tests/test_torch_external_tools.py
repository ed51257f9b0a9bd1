"""The port's external scorers (``gcpnet_torch.utils.external_tools``)
against the JAX package's, on the CPU.

- Stub executables written into ``tmp_path`` print the TM-score, lddt
  and MolProbity output formats; the port's and the JAX functions give
  equal dicts and arrays on them (the lddt table's unreadable score
  counts 0 in both).
- Without a configured path: the native TM-score bundle and lDDT (per
  residue and global) of both packages on synthetic decoys, fp32 atol
  1e-6; MolProbity gives ``{}`` in both.
- The deliberate difference: a configured executable that is missing, or
  prints nothing parseable, raises in the port where the JAX functions
  fall back to native scores.
- EQ's labels through ``lddt_exec_path``: ``featurize_decoy`` of both
  packages on the same stub, the datamodule's graph cache keyed on the
  scorer (native labels are never read back as the binary's), and
  ``datamodule=eq datamodule.lddt_exec_path=<stub>`` composed and trained
  one CPU step through ``python -m gcpnet_torch.train``.
- AR's score rows go through the scorer, as the JAX writer's do.
"""

import os
import subprocess
import sys
from pathlib import Path

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest

import gcpnet_tpu.data.native as jnative
from chip_smoke import write_lddt_stub
from gcpnet_tpu.data import eq as jeq
from gcpnet_tpu.utils import external_tools as jtools
from gcpnet_torch.data import eq
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.utils import external_tools as tools
from gcpnet_torch.utils.structure_metrics import matched_lddt

REPO = Path(__file__).resolve().parent.parent

TMSCORE_OUT = """
 *****************************************************************************
 *                                 TM-SCORE                                  *
 *****************************************************************************
Structure1: model.pdb    Length=  120
Structure2: native.pdb   Length=  118 (by which all scores are normalized)
Number of residues in common=  118
RMSD of  the common residues=    2.417

TM-score    = 0.8123  (d0= 3.93, TM10= 0.8021)
MaxSub-score= 0.7012  (d0= 3.50)
GDT-TS-score= 0.7352 %(d<1)=0.4746 %(d<2)=0.6864 %(d<4)=0.8729 %(d<8)=0.9068
GDT-HA-score= 0.5826 %(d<0.5)=0.2966 %(d<1)=0.4746 %(d<2)=0.6864 %(d<4)=0.8729
"""
LDDT_OUT = """lddt
Global LDDT score: 0.7000
Local LDDT Scores:
Chain\tResName\tResNum\tAsses.\tScore\t(Conserved/Total, over 4 thresholds)
A\tMET\t1\tYes\t0.8123\t(10/12)
A\tALA\t2\tYes\t-\t(0/0)
A\tGLY\t3\tYes\t0.4567\t(8/12)
short line
A\tLYS\t4\tYes\t0.9999\t(12/12)
"""


def _stub(tmp_path, name, out: str, code: int = 0) -> str:
    """An executable that prints ``out`` whatever its arguments."""
    path = tmp_path / name
    path.write_text(f"#!{sys.executable}\nimport sys\nsys.stdout.write({out!r})\nsys.exit({code})\n")
    path.chmod(0o755)
    return str(path)


@pytest.fixture(scope="module")
def eq_root(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("eq"))
    write_eq_decoys(root, seed=4, targets={"train": 2, "valid": 1, "test": 1}, decoys=2, residues=(10, 25))
    return root


def _pairs(eq_root):
    decoys = sorted(os.listdir(os.path.join(eq_root, "decoy_model")))
    return [(os.path.join(eq_root, "decoy_model", d), os.path.join(eq_root, "true_model", d.split("_")[0] + ".pdb"))
            for d in decoys]


def test_binaries_outputs_parse_as_in_jax(tmp_path):
    tm = _stub(tmp_path, "TMscore", TMSCORE_OUT)
    got = tools.calculate_tmscore_metrics("a.pdb", "b.pdb", tm)
    assert got == jtools.calculate_tmscore_metrics("a.pdb", "b.pdb", tm)
    assert got == {"TM-score": 0.8123, "GDT-TS": 0.7352, "GDT-HA": 0.5826, "MaxSub": 0.7012, "RMSD": 2.417}
    lddt = _stub(tmp_path, "lddt", LDDT_OUT)
    got = tools.generate_lddt_score("a.pdb", "b.pdb", lddt)
    np.testing.assert_array_equal(got, jtools.generate_lddt_score("a.pdb", "b.pdb", lddt))
    np.testing.assert_array_equal(got, [0.8123, 0.0, 0.4567, 0.9999])
    assert tools.generate_lddt_score("a.pdb", "b.pdb", lddt, per_residue=False) == \
        jtools.generate_lddt_score("a.pdb", "b.pdb", lddt, per_residue=False)
    pdb = tmp_path / "model_7.pdb"
    fields = ["model_7"] + [f"{0.5 * i:.1f}" for i in range(1, 50)]
    mp = _stub(tmp_path, "molprobity", "other:1:2\n" + ":".join(fields) + "\n")
    got = tools.calculate_molprobity_metrics(str(pdb), mp)
    assert got == jtools.calculate_molprobity_metrics(str(pdb), mp)
    assert got == {"clash_score": 4.0, "rotamer_outliers": 8.5, "ramachandran_outliers": 10.0,
                   "molprobity_score": 22.5}


def test_native_fallbacks_match_jax(eq_root):
    for decoy, native in _pairs(eq_root)[:4]:
        got, want = tools.calculate_tmscore_metrics(decoy, native), jtools.calculate_tmscore_metrics(decoy, native)
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
        np.testing.assert_allclose(tools.generate_lddt_score(decoy, native),
                                   jtools.generate_lddt_score(decoy, native), atol=1e-6)
        np.testing.assert_allclose(tools.generate_lddt_score(decoy, native, per_residue=False),
                                   jtools.generate_lddt_score(decoy, native, per_residue=False), atol=1e-6)
        assert tools.calculate_molprobity_metrics(decoy) == jtools.calculate_molprobity_metrics(decoy) == {}


def test_a_configured_binary_that_fails_raises(tmp_path, eq_root):
    """The port raises where the JAX functions fall back (a deliberate
    difference: a label from another scorer than the one configured)."""
    decoy, native = _pairs(eq_root)[0]
    missing = str(tmp_path / "no-such-binary")
    silent = _stub(tmp_path, "silent", "nothing to read\n")
    for port_fn, jax_fn, args in (
        (tools.calculate_tmscore_metrics, jtools.calculate_tmscore_metrics, (decoy, native)),
        (tools.generate_lddt_score, jtools.generate_lddt_score, (decoy, native)),
    ):
        with pytest.raises(FileNotFoundError, match="no-such-binary"):
            port_fn(*args, missing)
        with pytest.raises(RuntimeError, match="no parseable output"):
            port_fn(*args, silent)
        native_scores = jax_fn(*args)
        for path in (missing, silent):
            got = jax_fn(*args, path)
            if isinstance(got, dict):
                assert got == native_scores
            else:
                np.testing.assert_array_equal(got, native_scores)
    with pytest.raises(FileNotFoundError):
        tools.calculate_molprobity_metrics(decoy, missing)
    with pytest.raises(RuntimeError, match="no parseable line"):
        tools.calculate_molprobity_metrics(decoy, silent)
    assert jtools.calculate_molprobity_metrics(decoy, missing) == jtools.calculate_molprobity_metrics(decoy, silent) \
        == {}


def _native_scores(eq_root, offset=0.0):
    return {os.path.basename(d): [s + offset for s in matched_lddt(d, n, per_residue=True)] for d, n in _pairs(eq_root)}


def test_eq_labels_through_the_binary_match_jax(eq_root, tmp_path, monkeypatch):
    monkeypatch.setattr(jnative, "radius_graph_native", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("off")))
    # the stub's scores: the native ones shifted, so that a native label cannot pass for the binary's
    stub = write_lddt_stub(str(tmp_path / "lddt"), _native_scores(eq_root, offset=-0.25), log=str(tmp_path / "calls"))
    cache = os.path.join(eq_root, "model_data_cache", "esm")
    for decoy, native in _pairs(eq_root)[:3]:
        got = eq.featurize_decoy(decoy, native, esm_cache_dir=cache, lddt_exec_path=stub)
        want = jeq.featurize_decoy(decoy, native, esm_cache_dir=cache, lddt_exec_path=stub)
        np.testing.assert_array_equal(got.extras["label"], want.extras["label"])
        plain = eq.featurize_decoy(decoy, native, esm_cache_dir=cache)
        np.testing.assert_allclose(got.extras["label"], plain.extras["label"] - 0.25, atol=1e-6)
    assert len((tmp_path / "calls").read_text().split()) == 6


def test_eq_graph_cache_is_keyed_on_the_scorer(eq_root, tmp_path):
    stub = write_lddt_stub(str(tmp_path / "lddt"), _native_scores(eq_root, offset=-0.25))
    kw = dict(model_data_cache_dir=str(tmp_path / "cache"), esm_cache_dir=os.path.join(eq_root, "model_data_cache",
                                                                                       "esm"),
              batch_size=1, max_nodes_per_batch=512, max_residues_per_batch=64)
    dirs = [os.path.join(eq_root, d) for d in ("splits", "decoy_model", "true_model")]
    labels = {}
    for scorer in (None, stub, None):
        dm = eq.EQDataModule(*dirs, lddt_exec_path=scorer, **kw)
        dm.setup()
        labels.setdefault(scorer, []).append(dm.featurize(dm.splits["valid"][0]).extras["label"])
    np.testing.assert_array_equal(labels[None][0], labels[None][1])  # read back from its own cache
    np.testing.assert_allclose(labels[stub][0], labels[None][0] - 0.25, atol=1e-6)
    names = sorted(os.listdir(tmp_path / "cache"))
    assert len(names) == 2 and sum("_lddt-" in n for n in names) == 1
    with pytest.raises(FileNotFoundError, match="lddt_exec_path"):
        eq.EQDataModule(*dirs, lddt_exec_path=str(tmp_path / "missing"), **kw)


ENTRY = r"""
import functools, runpy, sys
from gcpnet_torch.data import eq, registry
registry.DATAMODULES["EQDataModule"] = functools.partial(
    eq.EQDataModule, max_nodes_per_batch=320, max_residues_per_batch=40)
sys.argv = ["gcpnet_torch.train"] + sys.argv[1:]
runpy.run_module("gcpnet_torch.train", run_name="__main__")
"""


def test_eq_trains_with_lddt_exec_path_through_the_entry_point(tmp_path):
    root = tmp_path / "data"
    write_eq_decoys(str(root / "EQ"), seed=5, targets={"train": 1, "valid": 1, "test": 1}, decoys=1,
                    residues=(10, 15))
    eq_root = str(root / "EQ")
    stub = write_lddt_stub(str(tmp_path / "lddt"), _native_scores(eq_root), log=str(tmp_path / "calls"))
    args = ["experiment=gcpnet_eq", "datamodule=eq", f"datamodule.lddt_exec_path={stub}", f"paths.data_dir={root}",
            f"paths.output_dir={tmp_path / 'run'}", "trainer.accelerator=cpu", "trainer.max_epochs=1",
            "trainer.min_epochs=0", "model.model_cfg.num_encoder_layers=1", "extras.print_config=false", "test=false"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", ENTRY, *args], capture_output=True, text=True, cwd=str(tmp_path),
                         env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    called = (tmp_path / "calls").read_text().split()
    assert len(called) >= 2 and all("decoy_model" in c for c in called)
    cached = os.listdir(root / "EQ" / "model_data_cache")
    assert any("_lddt-" in name for name in cached)


def test_ar_scores_go_through_the_scorer(monkeypatch):
    from gcpnet_torch.data import ar

    assert ar.calculate_tmscore_metrics is tools.calculate_tmscore_metrics
    assert ar.generate_lddt_score is tools.generate_lddt_score
