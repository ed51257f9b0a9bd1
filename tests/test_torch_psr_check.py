"""Adam's first step, the arithmetic behind chip_smoke's psr-check bound.

The port's Adam (``gcpnet_torch.train.optim.Adam``, optax's formulas) moves
each parameter on its first step by ``lr * g / (|g| + eps)``: about
``lr * sign(g)`` whatever the gradient's size.  Two gradients that agree
within any bound can therefore move an entry whose gradient lies within
that bound of 0 by up to ``2 lr`` apart, in opposite directions, where the
entries with gradients of one sign move within rounding of each other.
``chip_smoke.adam_sign_flips`` finds those entries; psr-check holds every
other entry of the card's first step to the CPU's at 1e-4.
"""

import _torch_threads  # noqa: F401  (torch's threads: this worker's share of the cores)
import numpy as np
import torch

from chip_smoke import TRAIN_CHECK_ATOL, adam_sign_flips
from gcpnet_torch.train.optim import Adam

LR = 1e-4


def _first_step(grad: torch.Tensor) -> torch.Tensor:
    """The parameter's move in one Adam step from 0 with gradient ``grad``."""
    p = torch.zeros_like(grad, requires_grad=True)
    opt = Adam([p], lr=LR)
    p.grad = grad.clone()
    opt.step()
    return p.detach()


def test_first_step_moves_each_entry_by_lr_times_sign():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(size=1000) * 10.0 ** rng.uniform(-7, 1, size=1000), dtype=torch.float32)
    moved = _first_step(g)
    want = -LR * g.double() / (g.double().abs() + 1e-8)
    np.testing.assert_allclose(moved.double().numpy(), want.numpy(), rtol=1e-5, atol=1e-12)
    big = g.abs() > 1e-6
    np.testing.assert_allclose(moved[big].numpy(), (-LR * torch.sign(g[big])).numpy(), rtol=1e-2)


def test_gradients_within_their_bound_can_part_by_two_lr():
    """Two gradients 2e-6 apart (inside any bound psr-check sets) that take
    opposite signs move their entry 2 lr apart, against a 1e-4 bound; the
    entries of one sign stay within rounding of each other."""
    g_cpu = torch.tensor([1e-6, -3.0, 0.5, 2e-5], dtype=torch.float32)
    g_card = torch.tensor([-1e-6, -3.0 + 1e-6, 0.5 - 1e-6, 2.2e-5], dtype=torch.float32)
    d = (_first_step(g_card) - _first_step(g_cpu)).abs()
    assert d[0].item() > 1.9 * LR > TRAIN_CHECK_ATOL["params"]
    assert d[1:].max().item() < 1e-7
    bound = TRAIN_CHECK_ATOL["grads_norm_rel"] * g_cpu.norm().item()
    flips = adam_sign_flips(g_card, g_cpu, bound)
    assert flips.tolist() == [True, False, False, False]
    assert d[~flips].max().item() <= TRAIN_CHECK_ATOL["params"]


def test_sign_flips_need_both_gradients_near_zero():
    """A sign change where either gradient is outside the bound is a real
    disagreement and stays held."""
    a = torch.tensor([1e-3, -1e-3, 0.0, 5e-4])
    b = torch.tensor([-1e-5, 1e-5, 1e-5, -5e-4])
    assert adam_sign_flips(a, b, 1e-4).tolist() == [False, False, True, False]
    assert adam_sign_flips(a, b, 1e-3).tolist() == [True, True, True, True]
