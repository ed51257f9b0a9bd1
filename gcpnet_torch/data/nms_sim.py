"""Newtonian many-body simulators for the NMS task.

The port's copy of ``gcpnet_tpu/data/nms_sim.py``: leapfrog integration
(dt 1e-3, forces clamped to ±100 componentwise) of charged particles under
Coulomb forces, optionally plus a uniform gravity field (``static``), a
Lorentz force (``dynamic``), or spring couplings (``springs``), for a whole
batch of simulations at once.  Charges are ±1 with p = 1/2, ``loc_std = (n /
5)^(1/3)``, initial speed 0.5; trajectories of T = 5000 steps sampled every
100 (49 frames); the dataset pairs frame 30 with frame 40.

Two integrators, fed the same initial conditions from the same seeded
``np.random.Generator`` stream:

- ``"numpy"``: the per-step loop on the host;
- ``"torch"``: the same float64 leapfrog in the same op order on a torch
  device, the card by default (the counterpart of the JAX package's default
  ``"xla"`` backend, a float64 ``lax.scan`` on the host).  On the card it
  makes thousands of trajectories in seconds, where the numpy loop spends
  milliseconds a step in dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

import numpy as np
import torch

from gcpnet_torch.device import DeviceLike, resolve_device

Mode = Literal["small", "small_20body", "static", "dynamic", "springs", "fixcharge"]
BACKENDS = ("numpy", "torch")


@dataclasses.dataclass
class SimConfig:
    mode: Mode = "small"
    n_balls: int = 5
    box_size: float = 5.0
    loc_std: float = 1.0
    vel_norm: float = 0.5
    interaction_strength: float = 1.0
    dt: float = 1e-3
    max_force: float = 0.1 / 1e-3
    gravity_constant: float = 0.098  # 'static' mode, +z field
    lorentz_field: Tuple[float, float, float] = (0.5, 0.5, 0.5)  # 'dynamic'
    noise_var: float = 0.0

    @classmethod
    def for_mode(cls, mode: Mode) -> "SimConfig":
        n = 5 if mode == "small" else 20
        if mode == "springs":
            return cls(mode=mode, n_balls=n, loc_std=0.5, interaction_strength=0.1)
        return cls(mode=mode, n_balls=n)


def _pair_forces(cfg: SimConfig, loc, edges, zero_diagonal):
    """Coulomb (or spring) forces ``[B, n, 3]`` for positions ``[B, n, 3]``
    and charge products (or spring constants) ``[B, n, n]``; numpy or torch
    arrays alike, in the same op order."""
    diff = loc[:, :, None, :] - loc[:, None, :, :]  # r_i - r_j
    if cfg.mode == "springs":
        size = -cfg.interaction_strength * edges
    else:
        d2 = (diff * diff).sum(-1) + 1e-6
        size = cfg.interaction_strength * edges * d2 ** (-1.5)
    size = zero_diagonal(size)
    return (size[..., None] * diff).sum(2)


def _numpy_integrate(cfg, edges, charges, pos, v, T, sample_freq, frames):
    n = pos.shape[1]
    idx = np.arange(n)

    def zero_diagonal(size):
        size[:, idx, idx] = 0.0
        return size

    field = np.asarray(cfg.lorentz_field)

    def total_force(pos, v):
        F = _pair_forces(cfg, pos, edges, zero_diagonal)
        # field terms join before the clamp (the reference's ordering)
        if cfg.mode == "static":
            F = F + np.array([0.0, 0.0, cfg.gravity_constant])
        elif cfg.mode == "dynamic":
            F = F + np.cross(v, field) * charges
        return np.clip(F, -cfg.max_force, cfg.max_force)

    loc = np.empty((pos.shape[0], frames, n, 3), dtype=np.float64)
    vel = np.empty_like(loc)
    v = v + cfg.dt * total_force(pos, v)  # half-step leapfrog kick
    counter = 0
    for i in range(1, T):
        pos = pos + cfg.dt * v
        if i % sample_freq == 0:
            loc[:, counter] = pos
            vel[:, counter] = v
            counter += 1
        v = v + cfg.dt * total_force(pos, v)
    return loc, vel


@torch.no_grad()
def _torch_integrate(cfg, edges, charges, pos, v, T, sample_freq, frames, device):
    def put(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    edges, charges, pos, v = map(put, (edges, charges, pos, v))
    n = pos.shape[1]
    idx = torch.arange(n, device=device)

    def zero_diagonal(size):
        size[:, idx, idx] = 0.0
        return size

    gravity = put([0.0, 0.0, cfg.gravity_constant])
    field = put(cfg.lorentz_field).expand_as(v)

    def total_force(pos, v):
        F = _pair_forces(cfg, pos, edges, zero_diagonal)
        if cfg.mode == "static":
            F = F + gravity
        elif cfg.mode == "dynamic":
            F = F + torch.linalg.cross(v, field) * charges
        return torch.clamp(F, -cfg.max_force, cfg.max_force)

    loc = torch.empty((pos.shape[0], frames, n, 3), dtype=torch.float64, device=device)
    vel = torch.empty_like(loc)
    v = v + cfg.dt * total_force(pos, v)
    counter = 0
    for i in range(1, T):
        pos = pos + cfg.dt * v
        if i % sample_freq == 0:
            loc[:, counter] = pos
            vel[:, counter] = v
            counter += 1
        v = v + cfg.dt * total_force(pos, v)
    return loc.cpu().numpy(), vel.cpu().numpy()


def simulate_batch(
    cfg: SimConfig,
    num_sims: int,
    rng: np.random.Generator,
    T: int = 5000,
    sample_freq: int = 100,
    backend: str = "torch",
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Simulate ``num_sims`` trajectories at once.

    Returns float32 ``(loc [B, F, n, 3], vel [B, F, n, 3], edges [B, n, n],
    charges [B, n, 1])`` with ``F = T // sample_freq - 1`` frames.  The
    ``"torch"`` backend integrates on ``device`` (``None``: the card)."""
    if backend not in BACKENDS:
        raise ValueError(f"simulate_batch: backend {backend!r} not in {BACKENDS}")
    n = cfg.n_balls
    B = num_sims
    frames = T // sample_freq - 1
    loc_std = cfg.loc_std * (n / 5.0) ** (1.0 / 3.0)

    if cfg.mode == "springs":
        k = rng.choice(np.array([0.0, 0.5, 1.0]), size=(B, n, n))
        k = np.triu(k, 1)
        edges = k + np.transpose(k, (0, 2, 1))
        charges = np.ones((B, n, 1))
    else:
        charges = rng.choice(np.array([-1.0, 1.0]), size=(B, n, 1))
        edges = charges @ np.transpose(charges, (0, 2, 1))

    pos = rng.standard_normal((B, n, 3)) * loc_std
    v = rng.standard_normal((B, n, 3))
    v = v * cfg.vel_norm / np.linalg.norm(v, axis=-1, keepdims=True)

    # reflect the initial positions into the box (the reference's _clamp);
    # the integration itself leaves them unclamped
    over = pos > cfg.box_size
    pos[over] = 2 * cfg.box_size - pos[over]
    v[over] = -np.abs(v[over])
    under = pos < -cfg.box_size
    pos[under] = -2 * cfg.box_size - pos[under]
    v[under] = np.abs(v[under])

    if backend == "torch":
        loc, vel = _torch_integrate(
            cfg, edges, charges, pos, v, T, sample_freq, frames, resolve_device(device)
        )
    else:
        loc, vel = _numpy_integrate(cfg, edges, charges, pos, v, T, sample_freq, frames)

    if cfg.noise_var > 0:
        loc += rng.standard_normal(loc.shape) * cfg.noise_var
        vel += rng.standard_normal(vel.shape) * cfg.noise_var
    return (
        loc.astype(np.float32),
        vel.astype(np.float32),
        edges.astype(np.float32),
        charges.astype(np.float32),
    )


def generate_split(
    mode: Mode,
    num_sims: int,
    seed: int,
    T: int = 5000,
    sample_freq: int = 100,
    chunk: int = 512,
    backend: str = "torch",
    device: DeviceLike = None,
):
    """Generate a dataset split in chunks of ``chunk`` simulations, all
    drawn from one ``np.random.default_rng(seed)`` stream."""
    cfg = SimConfig.for_mode(mode)
    rng = np.random.default_rng(seed)
    parts = []
    remaining = num_sims
    while remaining > 0:
        b = min(chunk, remaining)
        parts.append(simulate_batch(cfg, b, rng, T, sample_freq, backend=backend, device=device))
        remaining -= b
    return tuple(np.concatenate(arrays) for arrays in zip(*parts))
