"""Budget batching in the port against the JAX package.

- ``pack_by_budget`` and ``make_bucket`` on random size lists, edge and
  node budgets, with graphs over the budget (dropped) and a shuffled
  order: exactly the JAX functions' batches and buckets;
- the datamodule registry: ``max_units > 0`` builds the budget's bucket
  for ATOM3D and CATH as the JAX registry does, NMS takes the key and
  reads it not, and the RS keys that neither package reads pass at any
  value.

The ATOM3D and CATH datamodules' budget epochs are held to the JAX
modules' in ``tests/test_torch_atom3d.py`` and ``tests/test_torch_cpd.py``,
RS's sampling order under ``stratified`` in ``tests/test_torch_rs.py``.
"""

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import pytest

from gcpnet_tpu.config.loader import compose as jcompose
from gcpnet_tpu.data import batching as jbatching
from gcpnet_tpu.data.registry import build_datamodule as jbuild_datamodule
from gcpnet_torch.config.loader import CONFIG_DIR, compose
from gcpnet_torch.data import batching
from gcpnet_torch.data.registry import build_datamodule


def _sizes(seed: int, n: int = 200):
    """``(nodes, edges)`` a graph: a few over any budget below drawn in."""
    rng = np.random.default_rng(seed)
    nodes = rng.integers(5, 600, size=n)
    edges = nodes * rng.integers(4, 33, size=n)
    return [(int(a), int(b)) for a, b in zip(nodes, edges)]


@pytest.mark.parametrize("unit,max_units", [("edge", 4000), ("edge", 12000), ("node", 300), ("node", 550)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shuffled", [False, True])
def test_pack_by_budget_matches_jax(unit, max_units, seed, shuffled):
    sizes = _sizes(seed)
    order = np.random.default_rng(seed + 10).permutation(len(sizes)) if shuffled else None
    got = batching.pack_by_budget(sizes, max_units, unit=unit, shuffle_order=order)
    want = jbatching.pack_by_budget(sizes, max_units, unit=unit, shuffle_order=order)
    assert got == want and len(got) > 1
    column = 1 if unit == "edge" else 0
    oversized = {i for i, s in enumerate(sizes) if s[column] > max_units}
    assert oversized and not oversized & {i for b in got for i in b}  # dropped, as the reference drops them
    assert all(sum(sizes[i][column] for i in b) <= max_units for b in got)


@pytest.mark.parametrize("unit", ["edge", "node"])
@pytest.mark.parametrize("max_units,num_graphs,avg_degree", [(262144, 16, 32), (4000, 3, 30.0), (100, 1, 0.5)])
def test_make_bucket_matches_jax(unit, max_units, num_graphs, avg_degree):
    got = batching.make_bucket(max_units, unit, num_graphs, avg_degree=avg_degree)
    want = jbatching.make_bucket(max_units, unit, num_graphs, avg_degree=avg_degree)
    assert (got.num_nodes, got.num_edges, got.num_graphs) == (want.num_nodes, want.num_edges, want.num_graphs)
    if unit == "edge":
        assert got.num_nodes == int(max_units / max(avg_degree, 1.0) * 1.5) + 8 and got.num_edges == max_units


@pytest.mark.parametrize("experiment,overrides", [
    ("gcpnet_lba", ["datamodule.max_units=262144"]),
    ("gcpnet_psr", ["datamodule.max_units=4096", "datamodule.unit=node"]),
    ("gcpnet_cpd", ["datamodule.max_units=20000"]),
    ("gcpnet_nms_small", ["datamodule.max_units=5000"]),
    ("gcpnet_rs", ["datamodule.stratified=true", "datamodule.without_replacement=false",
                   "datamodule.grouping=smiles", "datamodule.sample_1_conformer=true",
                   "datamodule.mask_coordinates=true"]),
])
def test_registry_takes_the_budget_and_the_unread_keys(experiment, overrides):
    cfg = compose(CONFIG_DIR, "train.yaml", [f"experiment={experiment}", *overrides])
    assert cfg == jcompose(CONFIG_DIR, "train.yaml", [f"experiment={experiment}", *overrides])
    dm = build_datamodule(cfg["datamodule"], device="cpu")
    jdm = jbuild_datamodule(cfg["datamodule"])
    for key in ("max_units", "unit"):
        assert getattr(dm, key, None) == getattr(jdm, key, None), key
    if hasattr(jdm, "_bucket"):
        got, want = dm.bucket(), jdm._bucket()
        assert (got.num_nodes, got.num_edges, got.num_graphs) == (want.num_nodes, want.num_edges, want.num_graphs)
