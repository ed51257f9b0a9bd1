"""Helpers shared by the tests that hold gcpnet_torch against gcpnet_tpu:
the same numpy inputs and the same weights go to the JAX function and to
its port, on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gcpnet_torch.weights import from_jax_params


def random_graphs(rng: np.random.Generator, num_graphs: int = 2, nodes: int = 20, edges: int = 70):
    """Keyword dicts of random LBA-shaped graphs, for either package's
    ``GraphData``."""
    out = []
    for _ in range(num_graphs):
        out.append(
            dict(
                h=rng.integers(0, 9, size=nodes).astype(np.int32),
                chi=rng.normal(size=(nodes, 2, 3)).astype(np.float32),
                e=rng.normal(size=(edges, 16)).astype(np.float32),
                xi=rng.normal(size=(edges, 1, 3)).astype(np.float32),
                x=(rng.normal(size=(nodes, 3)) * 4).astype(np.float32),
                senders=rng.integers(0, nodes, size=edges).astype(np.int32),
                receivers=rng.integers(0, nodes, size=edges).astype(np.int32),
                extras={"label": np.float32(rng.normal())},
            )
        )
    return out


def to_jax(batch):
    """A host batch of the JAX package as device arrays."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a) if a is not None else None, batch)


def load_jax_params(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load a flax variable tree into a port module (strict names)."""
    module.load_state_dict(from_jax_params(variables))
    return module


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy/JAX array -> torch tensor (floats in ``dtype``)."""
    arr = np.asarray(a)
    out = torch.from_numpy(arr.copy())
    return out.to(dtype) if out.is_floating_point() else out


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)
