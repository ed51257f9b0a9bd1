"""The Geometry-Complete Perceptron (GCP2, GCP3) and its linear layers.

Port of the module path of ``gcpnet_tpu/nn/gcp.py``.  Parameters keep the
flax names and the flax ``[in, out]`` kernel layout (see
``gcpnet_torch.weights``).  The JAX package's ``_fused_edge_call`` and
``MessageOperands`` are TPU re-associations of this same math and are not
needed here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import ModuleCfg
from gcpnet_torch.nn.frames import scalarize
from gcpnet_torch.nn.primitives import ScalarVector, get_nonlinearity, is_identity, safe_vec_norm


def uniform_param(shape, bound: float, generator: torch.Generator, device) -> nn.Parameter:
    """``U(-bound, bound)`` drawn on the CPU from ``generator``, then moved,
    so a seed gives the same weights on every device."""
    w = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w.to(device))


class Dense(nn.Module):
    """Linear layer with torch-style ``U(±1/√fan_in)`` init for kernel and
    bias; ``kernel`` is ``[in, out]``."""

    def __init__(
        self, in_features: int, features: int, *, generator: torch.Generator,
        device, use_bias: bool = True,
    ):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.kernel = uniform_param((in_features, features), bound, generator, device)
        self.bias = (
            uniform_param((features,), bound, generator, device) if use_bias else None
        )

    def forward(self, x: Tensor) -> Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class VecDense(nn.Module):
    """Bias-free channel mixing over packed vectors ``[..., 3*din] ->
    [..., 3*dout]``: one ``[din, dout]`` kernel applied to each axis block
    (equivariant)."""

    def __init__(
        self, in_features: int, features: int, *, generator: torch.Generator,
        device, init_gain: float = 1.0,
    ):
        super().__init__()
        bound = init_gain / math.sqrt(in_features)
        self.kernel = uniform_param((in_features, features), bound, generator, device)

    def forward(self, vp: Tensor) -> Tensor:
        din, dout = self.kernel.shape
        blocks = vp.reshape(*vp.shape[:-1], 3, din) @ self.kernel
        return blocks.reshape(*vp.shape[:-1], 3 * dout)


@dataclasses.dataclass(frozen=True)
class GCPSettings:
    """Fully resolved per-module hyperparameters (module_cfg plus call-site
    overrides)."""

    scalar_nonlinearity: Optional[str] = "relu"
    vector_nonlinearity: Optional[str] = None
    scalar_gate: int = 0
    vector_gate: bool = True
    frame_gate: bool = False
    sigma_frame_gate: bool = False
    bottleneck: int = 1
    vector_residual: bool = False
    vector_frame_residual: bool = False
    ablate_frame_updates: bool = False
    ablate_scalars: bool = False
    ablate_vectors: bool = False
    enable_e3_equivariance: bool = False
    sv_dim: int = 3  # scalarization_vectorization_output_dim
    feedforward_out: bool = False  # GCP3
    scalar_out_nonlinearity: Optional[str] = "silu"  # GCP3
    nonlinearity_slope: float = 1e-2

    @classmethod
    def from_cfg(cls, cfg: ModuleCfg, **overrides) -> "GCPSettings":
        base = dict(
            scalar_nonlinearity=cfg.scalar_nonlinearity,
            vector_nonlinearity=cfg.vector_nonlinearity,
            scalar_gate=cfg.scalar_gate,
            vector_gate=cfg.vector_gate,
            frame_gate=cfg.frame_gate,
            sigma_frame_gate=cfg.sigma_frame_gate,
            bottleneck=cfg.bottleneck,
            vector_residual=cfg.vector_residual,
            vector_frame_residual=cfg.vector_frame_residual,
            ablate_frame_updates=cfg.ablate_frame_updates,
            ablate_scalars=cfg.ablate_scalars,
            ablate_vectors=cfg.ablate_vectors,
            enable_e3_equivariance=cfg.enable_e3_equivariance,
            scalar_out_nonlinearity=cfg.scalar_out_nonlinearity,
        )
        if "nonlinearities" in overrides:
            nl = overrides.pop("nonlinearities")
            if nl is None:
                nl = (None, None)
            base["scalar_nonlinearity"], base["vector_nonlinearity"] = nl
        base.update(overrides)
        return cls(**base)


def _hidden_vec_dim(vec_in: int, vec_out: int, bottleneck: int) -> int:
    if bottleneck > 1:
        if vec_in % bottleneck != 0:
            raise ValueError(
                f"vector input dim {vec_in} not divisible by bottleneck {bottleneck}"
            )
        return vec_in // bottleneck
    return max(vec_in, vec_out)


class GCP2(nn.Module):
    """The default GCP variant: ``scalar_out([s ‖ ‖vector_down(v)‖ ‖
    scalarize(vector_down_frames(v))])`` for scalars, ``vector_up`` with a
    sigmoid gate (or a norm gate) for vectors.

    With ``ablate_frame_updates`` (CPD's decoder) the frames take no
    part: no ``vector_down_frames``, no scalarize term and no frame gate.
    The frame gate, E(3) mode, the other ablations and scalar-only inputs
    belong to other task models and are not ported yet; they raise.  GCP2
    ignores ``feedforward_out``, as the reference's GCP2 does
    (``gcpnet_tpu/nn/gcp.py:343-345``).
    """

    supports_feedforward_out = False

    def __init__(
        self,
        input_dims: Tuple[int, int],
        output_dims: Tuple[int, int],
        settings: GCPSettings,
        *,
        generator: torch.Generator,
        device,
    ):
        super().__init__()
        st = settings
        unported = [
            name
            for name in ("enable_e3_equivariance", "ablate_scalars", "ablate_vectors")
            if getattr(st, name)
        ]
        if st.frame_gate and not st.ablate_frame_updates:
            unported.append("frame_gate")
        if input_dims[1] <= 0:
            unported.append("scalar-only input")
        if unported:
            raise NotImplementedError(f"{type(self).__name__}: {unported} not ported yet")
        self.input_dims = tuple(input_dims)
        self.output_dims = tuple(output_dims)
        self.settings = st
        s_in, v_in = self.input_dims
        s_out, v_out = self.output_dims
        kw = dict(generator=generator, device=device)
        self.hidden = _hidden_vec_dim(v_in, v_out, st.bottleneck)
        self.vector_down = VecDense(v_in, self.hidden, **kw)
        frame_dims = 0
        if not st.ablate_frame_updates:
            self.vector_down_frames = VecDense(v_in, st.sv_dim, **kw)
            frame_dims = 3 * st.sv_dim
        merged = s_in + self.hidden + frame_dims
        self.feedforward_out = st.feedforward_out and self.supports_feedforward_out
        if self.feedforward_out:
            self.scalar_out_0 = Dense(merged, s_out, **kw)
            self.scalar_out_1 = Dense(s_out, s_out, **kw)
        else:
            self.scalar_out = Dense(merged, s_out, **kw)
        if v_out:
            self.vector_up = VecDense(self.hidden, v_out, **kw)
            if st.vector_gate:
                self.vector_out_scale = Dense(s_out, v_out, **kw)

    def forward(self, rep, frames: Optional[Tensor], frame_mask: Optional[Tensor] = None):
        """``rep`` is a ``ScalarVector``.  ``frames`` are the rows' frames:
        edge frames for edge inputs (then ``frame_mask`` gates the scalarize
        numerators), or ``node_mean_frames`` for node inputs (already
        masked); unread (may be ``None``) with ``ablate_frame_updates``.
        Returns a ``ScalarVector``, or the scalars alone when the output has
        no vector channels."""
        st = self.settings
        act_s = get_nonlinearity(st.scalar_nonlinearity, st.nonlinearity_slope)
        act_v = get_nonlinearity(st.vector_nonlinearity, st.nonlinearity_slope)
        scalar_rep, vector_rep = rep
        vh = self.vector_down(vector_rep)
        merged = [scalar_rep, safe_vec_norm(vh)]
        if not st.ablate_frame_updates:
            merged.append(scalarize(self.vector_down_frames(vector_rep), frames, frame_mask))
        merged = torch.cat(merged, dim=-1)
        if self.feedforward_out:
            act_out = get_nonlinearity(st.scalar_out_nonlinearity, st.nonlinearity_slope)
            s_new = self.scalar_out_1(act_out(self.scalar_out_0(merged)))
        else:
            s_new = self.scalar_out(merged)
        if not self.output_dims[1]:
            return act_s(s_new)

        vu = self.vector_up(vh)
        if st.vector_residual:
            vu = vu + vector_rep
        if st.vector_gate:
            gate = torch.sigmoid(self.vector_out_scale(act_v(s_new)))
            vu = vu * gate.repeat(1, 3)
        elif not is_identity(st.vector_nonlinearity):
            vu = vu * act_v(safe_vec_norm(vu)).repeat(1, 3)
        return ScalarVector(act_s(s_new), vu)


class GCP3(GCP2):
    """GCP2 with an optional two-layer scalar output (EQ, AR):
    ``feedforward_out`` replaces ``scalar_out`` by ``scalar_out_1(act(
    scalar_out_0(merged)))``, ``act`` the ``scalar_out_nonlinearity``
    (silu by default) (``gcpnet_tpu/nn/gcp.py:771-778``).  Without it
    GCP3 is GCP2."""

    supports_feedforward_out = True


GCP_CLASSES = {"GCP2": GCP2, "GCP3": GCP3}


def make_gcp(
    input_dims: Tuple[int, int],
    output_dims: Tuple[int, int],
    cfg: ModuleCfg,
    *,
    generator: torch.Generator,
    device,
    **overrides,
) -> GCP2:
    """Build the configured GCP variant with call-site overrides: GCP2 (LBA,
    PSR, CPD, NMS, RS) or GCP3 (EQ); GCP v1 is not ported yet."""
    if cfg.selected_gcp not in GCP_CLASSES:
        raise NotImplementedError(f"GCP variant {cfg.selected_gcp!r} is not ported yet")
    settings = GCPSettings.from_cfg(cfg, **overrides)
    return GCP_CLASSES[cfg.selected_gcp](input_dims, output_dims, settings, generator=generator, device=device)
