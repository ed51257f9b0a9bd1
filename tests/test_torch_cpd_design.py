"""The port's CPD design path against the JAX package, on the CPU: the
autoregressive sampler, the test-time evaluation, the task wiring and the
``--task cpd`` entry point.

- The sampler at temperature 1e-6 (an argmax: the two packages draw from
  different generators) against the JAX ``GCPNetCPD.sample`` on copies of
  a chain with a masked residue, the same parameters carried by
  ``weights.py``: the sequences equal.  At temperature 0.1 each drawn
  residue follows ``softmax(logits / 0.1)`` of the logits the sampler
  projected at its position: per class, the count drawn against the sum
  of those probabilities, within 5 standard deviations, and at position 0
  (the same logits in every copy) the frequencies against the
  probabilities.
- ``datum_perplexity`` and ``evaluate_cpd`` (``all``, ``short`` and
  ``single_chain``; recovery at temperature 1e-6) against the JAX
  functions: the same keys and values at fp32 atol 1e-4; a chain over the
  bucket left out, a ``RuntimeError`` raised.
- Causality on the port (``tests/test_cpd_causality.py``'s property): a
  node's logits do not depend on the residues at its position or later.
- The CPD collect function adds what the JAX one adds; ``--task cpd`` on
  the CPU at a small bucket trains, tests and prints the design metrics,
  and refuses to fall back to the CPU without ``--device cpu``.
"""

import functools
import json

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import jax
import numpy as np
import pytest
import torch

from gcpnet_tpu import tasks as jtasks
from gcpnet_tpu.data.protein_graph import featurize_protein as j_featurize
from gcpnet_tpu.models import cpd_eval as jcpd_eval
from gcpnet_tpu.models.cpd import GCPNetCPD as JGCPNetCPD
from gcpnet_tpu.train.metrics import Collector as JCollector
from gcpnet_torch import tasks
from gcpnet_torch.config.schema import LayerCfg, ModelCfg, ModuleCfg, MPCfg
from gcpnet_torch.data import cath
from gcpnet_torch.data.batching import Bucket, batches_from_dataset
from gcpnet_torch.data.protein_graph import featurize_protein
from gcpnet_torch.models import cpd_eval
from gcpnet_torch.models.cpd import GCPNetCPD, cpd_loss
from gcpnet_torch.ops import segment
from gcpnet_torch.data import registry
from gcpnet_torch.train import cli as train_cli
from gcpnet_torch.train.metrics import Collector
from test_torch_cpd import CPD_MESSAGE_LAYERS, CPD_MODEL, cpd_chain, cpd_models, jax_batch, write_cath

ATOL = 1e-4


def copies_batch(graph, copies: int):
    """``copies`` copies of one chain in a bucket of exactly their size."""
    n = graph.num_nodes
    return next(batches_from_dataset([graph] * copies, Bucket(n * copies, graph.num_edges * copies, copies)))


@pytest.fixture(scope="module")
def chain():
    """A 14-residue chain with residue 5 masked, featurized by the port and
    by the JAX package (the same arrays)."""
    record = cpd_chain(np.random.default_rng(21), 14)
    record["coords"][5] = np.nan
    return featurize_protein(record), j_featurize(record)


@pytest.fixture(scope="module")
def models(chain):
    graph, _ = chain
    return cpd_models(True, jax_batch(copies_batch(graph, 2)))


def test_argmax_samples_match_jax(chain, models):
    graph, _ = chain
    jmodel, params, port = models
    batch = copies_batch(graph, 3)
    n = graph.num_nodes
    want = np.asarray(jmodel.apply(params, jax_batch(batch), jax.random.key(0), n, 1e-6, method=JGCPNetCPD.sample))
    got = port.sample(batch.to("cpu"), n, 1e-6, torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.reshape(3, n)[:, 5].tolist() == [0, 0, 0]  # the masked residue is never sampled
    assert len(set(got.tolist())) > 1


@pytest.mark.parametrize("path", ["sample", "train_step"])
def test_sorted_batches_reach_no_scatter(chain, models, monkeypatch, path):
    """The sampler's per-position subgraphs and a teacher-forced training
    step carry every index they sum by in its sorted form: with the
    ``index_add_`` fallback (``ops.segment._plain_on_cpu``, which the card
    refuses) made to raise on the CPU too, both run and give what they gave
    before."""
    graph, _ = chain
    _, _, port = models
    batch = copies_batch(graph, 2).to("cpu")

    def run():
        if path == "sample":
            return port.sample(batch, graph.num_nodes, 0.1, torch.Generator().manual_seed(0))
        port.zero_grad()
        cpd_loss(port(batch), batch)[0].backward()
        return torch.cat([p.grad.reshape(-1) for p in port.parameters()])

    want = run()

    def refuse(t, what):
        raise AssertionError(f"{what} took the index_add_ fallback")

    monkeypatch.setattr(segment, "_plain_on_cpu", refuse)
    assert torch.equal(run(), want)


def test_draws_follow_the_tempered_softmax(chain, models):
    """Temperature 0.1 over 400 copies: every drawn residue against
    softmax(logits / 0.1) of its position's projected logits (captured)."""
    graph, _ = chain
    _, _, port = models
    copies, n, tau = 400, graph.num_nodes, 0.1
    logits = []
    hook = port.invariant_node_projection.register_forward_hook(lambda m, i, out: logits.append(out))
    try:
        seq = port.sample(copies_batch(graph, copies).to("cpu"), n, tau, torch.Generator().manual_seed(1)).numpy()
    finally:
        hook.remove()
    positions = [i for i in range(n) if i != 5]
    assert len(logits) == len(positions)
    drawn = seq.reshape(copies, n)[:, positions].T  # [positions, copies]
    probs = torch.softmax(torch.stack(logits) / tau, -1).numpy()  # [positions, copies, 20]
    onehot = np.eye(20)[drawn]
    diff = (onehot - probs).sum(axis=(0, 1))
    sd = np.sqrt((probs * (1 - probs)).sum(axis=(0, 1)))
    assert np.all(np.abs(diff) <= 5 * sd + 1e-9), (diff, sd)
    # position 0: no causal edge, the same logits in every copy
    np.testing.assert_allclose(probs[0], np.broadcast_to(probs[0, :1], probs[0].shape), atol=1e-5)
    freq = onehot[0].mean(0)
    assert np.all(np.abs(freq - probs[0, 0]) <= 5 * np.sqrt(probs[0, 0] * (1 - probs[0, 0]) / copies) + 1e-9)


def test_perplexity_and_evaluation_match_jax(tmp_path, models, monkeypatch):
    """``datum_perplexity`` of a chain, and ``evaluate_cpd``'s medians over
    a fixture's test chains with 2 samples at temperature 1e-6.  The JAX
    ``datum_recovery`` does not hand its temperature to ``sample``, which
    then draws at its default 0.1 (the port hands it on); here that
    default is set to 1e-6, so both draw the argmax."""
    jmodel, params, port = models
    write_cath(str(tmp_path), np.random.default_rng(4), n_chains=6, n_test=2)
    dm = cath.CATHDataModule(data_dir=str(tmp_path))
    dm.setup()
    named = list(dm.named_graphs("test"))
    bucket = Bucket(64, 64 * 32, 2)
    want = jcpd_eval.datum_perplexity(jmodel, params["params"], _jax_graph(named[0][1]), _jax_bucket(bucket))
    np.testing.assert_allclose(cpd_eval.datum_perplexity(port, named[0][1], bucket), want, atol=ATOL)
    jax_sample = JGCPNetCPD.sample
    monkeypatch.setattr(JGCPNetCPD, "sample", lambda self, batch, rng, n, temperature=1e-6: jax_sample(
        self, batch, rng, n, temperature))
    kw = dict(custom_splits=dm.custom_splits, num_samples=2, temperature=1e-6, max_nodes=64)
    per_chain = []
    got = cpd_eval.evaluate_cpd(port, named, per_chain=per_chain, **kw)
    want = jcpd_eval.evaluate_cpd(jmodel, params["params"], [(n, _jax_graph(g)) for n, g in named], **kw)
    assert got.keys() == want.keys() == {f"test/{k}_{m}" for k in ("all", "short", "single_chain")
                                          for m in ("perplexity", "recovery")}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=ATOL, err_msg=key)
    assert [c[0] for c in per_chain] == [n for n, _ in named] and all(c[3] > 0 for c in per_chain)
    no_recovery = cpd_eval.evaluate_cpd(port, named, dm.custom_splits, compute_recovery=False, max_nodes=64)
    assert no_recovery.keys() == {f"test/{k}_perplexity" for k in ("all", "short", "single_chain")}


def test_evaluation_leaves_out_bad_chains_and_stops_on_runtime_errors(chain, models, monkeypatch):
    """A chain over the bucket (``ValueError``) is logged and left out, as
    in the JAX function; a ``RuntimeError`` (a failed launch, a CUDA error)
    ends the evaluation instead of dropping every later chain."""
    graph, _ = chain
    _, _, port = models
    small = featurize_protein(cpd_chain(np.random.default_rng(5), 6))
    per_chain = []
    got = cpd_eval.evaluate_cpd(port, [("long", graph), ("small", small)], compute_recovery=False, max_nodes=10,
                                per_chain=per_chain)
    assert [c[0] for c in per_chain] == ["small"] and set(got) == {"test/all_perplexity"}

    def fails(*args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(cpd_eval, "datum_perplexity", fails)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cpd_eval.evaluate_cpd(port, [("small", small)], compute_recovery=False, max_nodes=10)


def _jax_graph(graph):
    from gcpnet_tpu.graph import GraphData as JGraphData

    return JGraphData(**{k: getattr(graph, k) for k in (
        "h", "chi", "e", "xi", "x", "senders", "receivers", "node_mask", "extras")})


def _jax_bucket(bucket):
    from gcpnet_tpu.data.batching import Bucket as JBucket

    return JBucket(bucket.num_nodes, bucket.num_edges, bucket.num_graphs)


def test_decoder_is_causal():
    """Mutating residue 0 leaves node 0's logits and moves later nodes';
    mutating the last residue moves nothing (no causal edge carries it)."""
    rng = np.random.default_rng(13)
    n = 10
    from gcpnet_torch.graph import GraphData

    g = GraphData(
        h=rng.normal(size=(n, 6)).astype(np.float32), chi=rng.normal(size=(n, 3, 3)).astype(np.float32),
        e=rng.normal(size=(n * 4, 32)).astype(np.float32), xi=rng.normal(size=(n * 4, 1, 3)).astype(np.float32),
        x=rng.normal(size=(n, 3)).astype(np.float32), senders=rng.integers(0, n, size=n * 4).astype(np.int32),
        receivers=rng.integers(0, n, size=n * 4).astype(np.int32),
        extras={"seq": rng.integers(0, 20, size=n).astype(np.int32)},
    )
    batch = next(batches_from_dataset([g], Bucket(n, n * 4 + 1, 1))).to("cpu")
    model = GCPNetCPD(
        ModelCfg(**CPD_MODEL), ModuleCfg(), LayerCfg(mp_cfg=MPCfg(num_message_layers=CPD_MESSAGE_LAYERS)),
        autoregressive_decoder=True, generator=torch.Generator().manual_seed(0), device="cpu",
    )

    def logits_with(seq):
        with torch.no_grad():
            return model(batch.replace(extras={"seq": torch.as_tensor(seq)})).numpy()

    seq = batch.extras["seq"].numpy().copy()
    base = logits_with(seq)
    first, last = seq.copy(), seq.copy()
    first[0], last[-1] = (seq[0] + 7) % 20, (seq[-1] + 3) % 20
    moved = logits_with(first)
    np.testing.assert_allclose(moved[0], base[0], atol=1e-5)
    assert np.abs(moved[1:] - base[1:]).max() > 1e-6
    np.testing.assert_allclose(logits_with(last), base, atol=1e-5)


def test_collect_adds_what_jax_adds(tmp_path):
    write_cath(str(tmp_path), np.random.default_rng(5), n_chains=7)
    dm = cath.CATHDataModule(data_dir=str(tmp_path), batch_size=3, max_nodes_per_batch=64)
    dm.setup()
    batch = next(dm.train_batches(seed=0))
    logits = np.random.default_rng(2).normal(size=(batch.num_nodes, 20)).astype(np.float32)
    collect = tasks.build_collect("GCPNetCPD")
    kept = collect.keep(batch)
    assert sum(np.asarray(v).nbytes for v in kept.values() if v is not None) <= 16 * batch.num_nodes
    got, want = Collector(), JCollector()
    collect.add(got, logits, kept)
    jtasks.build_collect("GCPNetCPD")(want, (logits, None), batch)
    for g, w in zip(got.cat(), want.cat()):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    p, labels, _ = got.cat()
    for name, fn in tasks.build_metric_fns("GCPNetCPD").items():
        assert fn(p, labels) == jtasks.build_metric_fns("GCPNetCPD")[name](p, labels)


@pytest.fixture
def small_bucket(monkeypatch):
    """The entry point's datamodule with a bucket of 64 nodes in place of the
    JAX one (2,048), which would take minutes a step on the CPU."""
    monkeypatch.setitem(registry.DATAMODULES, "CATHDataModule", functools.partial(cath.CATHDataModule, max_nodes_per_batch=64))


def test_train_cpd_cpu_entry_point(tmp_path, small_bucket, capsys):
    write_cath(str(tmp_path), np.random.default_rng(6), n_chains=8)
    train_cli.main(["--task", "cpd", "--device", "cpu", "--data-dir", str(tmp_path), "--batch-size", "3",
                    "--num-encoder-layers", "1", "--max-epochs", "1", "--min-epochs", "0", "--num-samples", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["epoch"] == 0 and all(np.isfinite(lines[0][k]) for k in ("train/loss", "val/loss"))
    assert 0.0 <= lines[0]["val/recovery_argmax"] <= 1.0
    assert {"test/loss", "test/recovery_argmax"} <= lines[1].keys()
    assert lines[2].keys() == {f"test/{k}_{m}" for k in ("all", "short", "single_chain")
                               for m in ("perplexity", "recovery")}
    assert all(np.isfinite(v) for v in lines[2].values())


def test_cpd_entry_point_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    write_cath(str(tmp_path), np.random.default_rng(7), n_chains=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--task", "cpd", "--data-dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        train_cli.main(["--task", "cpd", "--device", "cpu", "--data-dir", str(tmp_path / "none")])
