"""The port's AMBER modules (``gcpnet_torch.utils.amber``) against the JAX
package's, on the CPU, on the synthetic structures of
``tests/test_amber_*.py`` (``_mk_atom``) and on synthetic EQ decoys.

- The clash check: the peptide exemption (C(i)-N(i+1) only, same chain,
  directed) and the disulfide exemption on hand-built pairs; random
  structures of several chains, with C/N/SG atoms placed to clash, through
  the blocked torch path (several blocks, and a block of one row) against
  the JAX dense one: equal masks.
- ``find_violations`` and ``structural_violations`` on decoys, on decoys
  squashed onto themselves and with a stretched peptide bond: equal masks,
  exact counts and fractions.
- The cleanup protocol (``clean_structure``, ``find_missing_heavy_atoms``,
  ``rebuild_backbone_oxygens``, ``clean_pdb``): the same structures,
  records and files.
- The relaxation raises ``ImportError`` without OpenMM, and
  ``external_tools.amber_relax`` returns ``False``, in both packages.
"""

import copy
import os

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest

from gcpnet_tpu.data import pdb as jpdb
from gcpnet_tpu.utils import external_tools as jtools
from gcpnet_tpu.utils.amber import cleanup as jcleanup
from gcpnet_tpu.utils.amber import violations as jviolations
from gcpnet_tpu.utils.amber.relax import AmberRelaxation as JAmberRelaxation
from gcpnet_torch.data import pdb
from gcpnet_torch.data.eq_synthetic import write_eq_decoys
from gcpnet_torch.utils import external_tools as tools
from gcpnet_torch.utils.amber import cleanup, violations
from gcpnet_torch.utils.amber.relax import AmberRelaxation

D = 1.3  # under the C + N overlap bound (1.7 + 1.55 - 1.5 = 1.75)


def _mk_atom(module, serial, name, resname, chain, resseq, x, y, z, element):
    return module.AtomRecord(serial=serial, name=name, altloc="", resname=resname, chain=chain, resseq=resseq,
                             icode="", x=x, y=y, z=z, occupancy=1.0, bfactor=0.0, element=element)


def _both(specs):
    """The same atoms as a structure of each package."""
    return (pdb.Structure(atoms=[_mk_atom(pdb, i + 1, *a) for i, a in enumerate(specs)]),
            jpdb.Structure(atoms=[_mk_atom(jpdb, i + 1, *a) for i, a in enumerate(specs)]))


def _clashes(s, js, block_rows=violations.CLASH_BLOCK_ROWS):
    got = violations.between_residue_clashes(s, "cpu", block_rows)["per_atom_clash_mask"]
    want = jviolations.between_residue_clashes(js)["per_atom_clash_mask"]
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("pair,clash", [
    ((("C", "ALA", "A", 1, "C"), ("N", "ALA", "A", 2, "N")), False),  # the bonded C(1)-N(2): exempt
    ((("N", "ALA", "A", 1, "N"), ("C", "ALA", "A", 2, "C")), True),  # N(1)-C(2) is no peptide bond
    ((("C", "ALA", "A", 1, "C"), ("N", "ALA", "B", 2, "N")), True),  # across chains
    ((("C", "ALA", "A", 1, "C"), ("N", "ALA", "A", 3, "N")), True),  # not consecutive
    ((("N", "ALA", "A", 2, "N"), ("C", "ALA", "A", 1, "C")), False),  # the bond, N listed first
    ((("SG", "CYS", "A", 1, "S"), ("SG", "CYS", "A", 5, "S")), False),  # a disulfide
    ((("SG", "CYS", "A", 1, "S"), ("SG", "SER", "A", 5, "S")), True),  # SG outside a cysteine
])
def test_clash_exemptions_match_jax(pair, clash):
    (n0, r0, c0, q0, e0), (n1, r1, c1, q1, e1) = pair
    s, js = _both([(n0, r0, c0, q0, 0.0, 0.0, 0.0, e0), (n1, r1, c1, q1, D, 0.0, 0.0, e1)])
    for block_rows in (1, 1024):
        assert _clashes(s, js, block_rows).tolist() == [clash, clash]


def _random_specs(rng, n_res=60, chains=("A", "B", "C")):
    """Residues of 4-7 atoms in a small box, chain by chain: C, N, CA, O,
    CB and, for cysteines, SG, so that peptide pairs, disulfides and
    clashes across chains all occur."""
    specs = []
    for chain in chains:
        for resseq in range(1, n_res // len(chains) + 1):
            resname = "CYS" if rng.random() < 0.3 else "ALA"
            names = ["N", "CA", "C", "O", "CB"] + (["SG"] if resname == "CYS" else [])
            for name in names:
                x, y, z = (rng.random(3) * 12.0).tolist()
                element = "S" if name == "SG" else name[0]
                specs.append((name, resname, chain, resseq, x, y, z, element))
    return specs


@pytest.mark.parametrize("seed", [0, 1])
def test_blocked_clash_check_matches_the_dense_one(seed):
    s, js = _both(_random_specs(np.random.default_rng(seed)))
    n = len(s.atoms)
    masks = [_clashes(s, js, block_rows) for block_rows in (1, 7, 64, n, 4 * n)]
    assert 0 < masks[0].sum() < n
    for mask in masks[1:]:
        np.testing.assert_array_equal(mask, masks[0])


@pytest.fixture(scope="module")
def decoys(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eq"))
    write_eq_decoys(root, seed=6, targets={"train": 2}, decoys=2, residues=(30, 60))
    d = os.path.join(root, "decoy_model")
    return [os.path.join(d, name) for name in sorted(os.listdir(d))]


def _assert_same_violations(got, want):
    assert got.keys() == want.keys()
    for key, value in got.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value, want[key], err_msg=key)
        else:
            assert value == want[key], key


def test_violations_on_decoys_match_jax(decoys):
    for path in decoys:
        s, js = pdb.parse_pdb(path, heavy_only=True), jpdb.parse_pdb(path, heavy_only=True)
        _assert_same_violations(violations.find_violations(s, "cpu"), jviolations.find_violations(js))
        assert violations.structural_violations(s, "cpu") == jviolations.structural_violations(js)
        # the second half squashed onto the first: clashes everywhere
        bad, jbad = copy.deepcopy(s), copy.deepcopy(js)
        half = len(s.atoms) // 2
        for struct in (bad, jbad):
            for i in range(half, len(struct.atoms)):
                src = struct.atoms[i - half]
                struct.atoms[i].x, struct.atoms[i].y, struct.atoms[i].z = src.x + 0.3, src.y, src.z
        got = violations.find_violations(bad, "cpu")
        _assert_same_violations(got, jviolations.find_violations(jbad))
        assert got["violations_between_residue_clash"] > violations.find_violations(s, "cpu")[
            "violations_between_residue_clash"]
        # a peptide bond stretched by 10 A
        res_idx = s.residue_index()
        split = int(res_idx.max()) // 2
        for struct in (bad, jbad):
            for i, a in enumerate(struct.atoms):
                a.x = (s.atoms[i].x + 10.0) if res_idx[i] > split else s.atoms[i].x
                a.y, a.z = s.atoms[i].y, s.atoms[i].z
        got = violations.find_violations(bad, "cpu")
        _assert_same_violations(got, jviolations.find_violations(jbad))
        assert got["per_residue_violation_mask"][split] or got["per_residue_violation_mask"][split + 1]
        assert violations.extreme_ca_ca_fraction(bad) == jviolations.extreme_ca_ca_fraction(jbad) > 0


def _cleanup_specs():
    gly = lambda chain, resseq, off: [  # noqa: E731
        ("N", "GLY", chain, resseq, off, 0.0, 0.0, "N"), ("CA", "GLY", chain, resseq, off + 1.46, 0.0, 0.0, "C"),
        ("C", "GLY", chain, resseq, off + 2.0, 1.4, 0.0, "C"),
    ]
    return ([("SE", "MSE", "A", 1, 0.0, 0.0, 0.0, "SE"), ("CA", "MSE", "A", 1, 1.4, 0.0, 0.0, "C")]
            + gly("A", 2, 4.0) + gly("A", 3, 7.3) + [("O", "GLY", "A", 3, 8.9, 2.5, 0.2, "O")]
            + [("O", "HOH", "A", 90, 9.0, 9.0, 9.0, "O"), ("C1", "LIG", "A", 91, 8.0, 8.0, 8.0, "C"),
               ("CA", "ALA", "B", 1, 20.0, 0.0, 0.0, "C"), ("SD", "MET", "A", 4, 12.0, 1.0, 0.0, "SE")])


def test_cleanup_matches_jax(tmp_path):
    s, js = _both(_cleanup_specs())
    info, jinfo = {}, {}
    cleaned = cleanup.clean_structure(s, info)
    jcleaned = jcleanup.clean_structure(js, jinfo)
    assert info == jinfo and info["removed_chains"] == {0: ["B"]} and info["Se_in_MET"] == [4]
    assert [vars(a) for a in cleaned.atoms] == [vars(a) for a in jcleaned.atoms]
    assert cleanup.find_missing_heavy_atoms(cleaned) == jcleanup.find_missing_heavy_atoms(jcleaned)
    rebuilt, added = cleanup.rebuild_backbone_oxygens(cleaned)
    jrebuilt, jadded = jcleanup.rebuild_backbone_oxygens(jcleaned)
    assert added == jadded == [("A", 2)]
    assert [vars(a) for a in rebuilt.atoms] == [vars(a) for a in jrebuilt.atoms]
    src = str(tmp_path / "in.pdb")
    pdb.write_structure(src, s)
    info, jinfo = {}, {}
    out = cleanup.clean_pdb(src, str(tmp_path / "port.pdb"), info)
    jout = jcleanup.clean_pdb(src, str(tmp_path / "jax.pdb"), jinfo)
    assert info == jinfo and "rebuilt_backbone_oxygens" in info
    assert open(out).read() == open(jout).read()


def test_relax_needs_openmm_in_both_packages(tmp_path, decoys, caplog):
    try:
        import openmm  # noqa: F401
        pytest.skip("OpenMM is installed: the relaxation itself would run")
    except ImportError:
        pass
    for relaxer in (AmberRelaxation(max_outer_iterations=1, device="cpu"), JAmberRelaxation(max_outer_iterations=1)):
        with pytest.raises(ImportError):
            relaxer.relax_pdb(decoys[0], str(tmp_path / "relaxed.pdb"))
    assert tools.amber_relax(decoys[0], str(tmp_path / "a.pdb"), device="cpu") is False
    assert jtools.amber_relax(decoys[0], str(tmp_path / "b.pdb")) is False
    assert AmberRelaxation.violation_metrics(decoys[0], "cpu") == JAmberRelaxation.violation_metrics(decoys[0])
