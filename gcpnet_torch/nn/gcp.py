"""The Geometry-Complete Perceptron family (GCP v1, GCP2, GCP3) and its
linear layers.

Port of the module path of ``gcpnet_tpu/nn/gcp.py``.  Parameters keep the
flax names and the flax ``[in, out]`` kernel layout (see
``gcpnet_torch.weights``).  The JAX package's ``_fused_edge_call`` and
``MessageOperands`` are TPU re-associations of this same math and are not
needed here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
from torch import Tensor, nn

from gcpnet_torch.config.schema import ModuleCfg
from gcpnet_torch.nn.frames import Frames, scalarize, vectorize
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


def _scalars(rep: Union[Tensor, ScalarVector]) -> Tensor:
    return rep.scalar if isinstance(rep, ScalarVector) else rep


def _tile3(x: Tensor) -> Tensor:
    """Per-channel gates repeated over the three packed xyz blocks."""
    return x.repeat(1, 3)


class GCP2(nn.Module):
    """The default GCP variant: ``scalar_out([s ‖ ‖vector_down(v)‖ ‖
    scalarize(vector_down_frames(v))])`` for scalars, ``vector_up`` with a
    frame gate, a sigmoid gate or a norm gate for vectors
    (``gcpnet_tpu/nn/gcp.py:357-484``).

    - ``ablate_frame_updates`` (CPD's decoder): the frames take no part (no
      ``vector_down_frames``, no scalarize term and no frame gate).
    - ``frame_gate``: the vectors are gated by the norms of
      ``vector_up_frames(vectorize(vector_out_scale_frames(act_v(s))))``.
    - ``enable_e3_equivariance``: scalarize's cross-product column in
      ``abs`` (reflection invariant), on edge and node rows.
    - ``ablate_scalars`` / ``ablate_vectors``: the input and the output
      scalars (vectors) are zeros.
    - An input without vector channels (``input_dims[1] == 0``; ``rep`` a
      tensor or a ``ScalarVector`` with empty vectors) has no vector branch:
      the scalars go to ``scalar_out`` alone, the output vectors are zeros.

    GCP2 ignores ``feedforward_out``, as the reference's GCP2 does
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
        self.input_dims = tuple(input_dims)
        self.output_dims = tuple(output_dims)
        self.settings = st
        s_in, v_in = self.input_dims
        s_out, v_out = self.output_dims
        kw = dict(generator=generator, device=device)
        merged = s_in
        if v_in:
            self.hidden = _hidden_vec_dim(v_in, v_out, st.bottleneck)
            self.vector_down = VecDense(v_in, self.hidden, **kw)
            merged += self.hidden
            if not st.ablate_frame_updates:
                self.vector_down_frames = VecDense(v_in, st.sv_dim, **kw)
                merged += 3 * st.sv_dim
        self.feedforward_out = st.feedforward_out and self.supports_feedforward_out
        if self.feedforward_out:
            self.scalar_out_0 = Dense(merged, s_out, **kw)
            self.scalar_out_1 = Dense(s_out, s_out, **kw)
        else:
            self.scalar_out = Dense(merged, s_out, **kw)
        self.frame_gate = bool(v_in and v_out and st.frame_gate and not st.ablate_frame_updates)
        if v_in and v_out:
            self.vector_up = VecDense(self.hidden, v_out, **kw)
            if self.frame_gate:
                self.vector_out_scale_frames = Dense(s_out, 3 * st.sv_dim, **kw)
                self.vector_up_frames = VecDense(st.sv_dim, v_out, **kw)
            elif st.vector_gate:
                self.vector_out_scale = Dense(s_out, v_out, **kw)

    def forward(self, rep, frames: Optional[Frames], frame_mask: Optional[Tensor] = None):
        """``rep`` is a ``ScalarVector`` (or the scalars alone where the
        input has no vector channels).  ``frames`` are edge frames for edge
        rows (then ``frame_mask`` gates the frame projections' rows) or a
        ``NodeFrames`` for node rows (a node-row tensor is taken as the rows'
        mean frames, which E(3) mode cannot use); unread (may be ``None``)
        with ``ablate_frame_updates``.  Returns a ``ScalarVector``, or the
        scalars alone when the output has no vector channels."""
        st = self.settings
        act_s = get_nonlinearity(st.scalar_nonlinearity, st.nonlinearity_slope)
        act_v = get_nonlinearity(st.vector_nonlinearity, st.nonlinearity_slope)
        v_in, v_out = self.input_dims[1], self.output_dims[1]
        if v_in:
            scalar_rep, vector_rep = rep
            if st.ablate_scalars:
                scalar_rep = torch.zeros_like(scalar_rep)
            if st.ablate_vectors:
                vector_rep = torch.zeros_like(vector_rep)
            vh = self.vector_down(vector_rep)
            merged = [scalar_rep, safe_vec_norm(vh)]
            if not st.ablate_frame_updates:
                vdf = self.vector_down_frames(vector_rep)
                merged.append(scalarize(vdf, frames, frame_mask, st.enable_e3_equivariance))
            merged = torch.cat(merged, dim=-1)
        else:
            merged = _scalars(rep)
        if self.feedforward_out:
            act_out = get_nonlinearity(st.scalar_out_nonlinearity, st.nonlinearity_slope)
            s_new = self.scalar_out_1(act_out(self.scalar_out_0(merged)))
        else:
            s_new = self.scalar_out(merged)
        if not v_out:
            return act_s(torch.zeros_like(s_new) if st.ablate_scalars else s_new)

        if not v_in:
            vu = s_new.new_zeros((s_new.shape[0], 3 * v_out))
        else:
            vu = self.vector_up(vh)
            if st.vector_residual:
                vu = vu + vector_rep
            if self.frame_gate:
                gate = vectorize(self.vector_out_scale_frames(act_v(s_new)), frames, frame_mask)
                vu = vu * _tile3(act_v(safe_vec_norm(self.vector_up_frames(gate))))
            elif st.vector_gate:
                vu = vu * _tile3(torch.sigmoid(self.vector_out_scale(act_v(s_new))))
            elif not is_identity(st.vector_nonlinearity):
                vu = vu * _tile3(act_v(safe_vec_norm(vu)))
        s = torch.zeros_like(s_new) if st.ablate_scalars else act_s(s_new)
        return ScalarVector(s, torch.zeros_like(vu) if st.ablate_vectors else vu)


class GCP3(GCP2):
    """GCP2 with an optional two-layer scalar output (EQ, AR):
    ``feedforward_out`` replaces ``scalar_out`` by ``scalar_out_1(act(
    scalar_out_0(merged)))``, ``act`` the ``scalar_out_nonlinearity``
    (silu by default) (``gcpnet_tpu/nn/gcp.py:771-778``).  Without it
    GCP3 is GCP2."""

    supports_feedforward_out = True


class GCP(nn.Module):
    """The original GCP (v1, ``gcpnet_tpu/nn/gcp.py:780-920``): a two-stage
    update.  Stage 1 is ``scalar_out([s ‖ ‖vector_down(v)‖])`` and
    ``vector_up`` with the vector gate (or a norm gate).  Stage 2 is
    ``scalar_out_frames([act(s') ‖ scalarize(vector_down_frames(v'))])``,
    ``v'`` the stage-1 vectors (the raw input vectors where the output has
    none), then the sigma frame gate (``sigmoid(
    vector_out_scale_sigma_frames(act_v(s'')))``) or the frame gate (with
    ``vector_frame_residual`` its input added back) on the stage-1 vectors.
    ``ablate_frame_updates`` returns after stage 1."""

    feedforward_out = False

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
        self.input_dims = tuple(input_dims)
        self.output_dims = tuple(output_dims)
        self.settings = st
        s_in, v_in = self.input_dims
        s_out, v_out = self.output_dims
        if not (v_in or v_out or st.ablate_frame_updates):
            raise ValueError("GCP: stage 2 projects vectors, and neither the input nor the output has any")
        kw = dict(generator=generator, device=device)
        merged = s_in
        if v_in:
            self.hidden = _hidden_vec_dim(v_in, v_out, st.bottleneck)
            self.vector_down = VecDense(v_in, self.hidden, **kw)
            merged += self.hidden
        self.scalar_out = Dense(merged, s_out, **kw)
        if v_in and v_out:
            self.vector_up = VecDense(self.hidden, v_out, **kw)
            if st.vector_gate:
                self.vector_out_scale = Dense(s_out, v_out, **kw)
        if st.ablate_frame_updates:
            return
        self.vector_down_frames = VecDense(v_out if v_out else v_in, st.sv_dim, **kw)
        self.scalar_out_frames = Dense(s_out + 3 * st.sv_dim, s_out, **kw)
        if v_in and v_out:
            if st.sigma_frame_gate:
                self.vector_out_scale_sigma_frames = Dense(s_out, v_out, **kw)
            elif st.frame_gate:
                self.vector_out_scale_frames = Dense(s_out, 3 * st.sv_dim, **kw)
                self.vector_up_frames = VecDense(st.sv_dim, v_out, **kw)

    def forward(self, rep, frames: Optional[Frames], frame_mask: Optional[Tensor] = None):
        """As :meth:`GCP2.forward`."""
        st = self.settings
        act_s = get_nonlinearity(st.scalar_nonlinearity, st.nonlinearity_slope)
        act_v = get_nonlinearity(st.vector_nonlinearity, st.nonlinearity_slope)
        v_in, v_out = self.input_dims[1], self.output_dims[1]
        vector_rep = None
        if v_in:
            scalar_rep, vector_rep = rep
            if st.ablate_scalars:
                scalar_rep = torch.zeros_like(scalar_rep)
            if st.ablate_vectors:
                vector_rep = torch.zeros_like(vector_rep)
            vh = self.vector_down(vector_rep)
            merged = torch.cat([scalar_rep, safe_vec_norm(vh)], dim=-1)
        else:
            merged = _scalars(rep)
            if st.ablate_scalars:
                merged = torch.zeros_like(merged)
        s = self.scalar_out(merged)

        new_vector = None
        if v_in and v_out:
            vu = self.vector_up(vh)
            if st.vector_residual:
                vu = vu + vector_rep
            if st.vector_gate:
                new_vector = vu * _tile3(torch.sigmoid(self.vector_out_scale(act_v(s))))
            elif not is_identity(st.vector_nonlinearity):
                new_vector = vu * _tile3(act_v(safe_vec_norm(vu)))
            else:
                new_vector = vu
        s = act_s(s)
        if v_out and not v_in:
            new_vector = s.new_zeros((s.shape[0], 3 * v_out))
        if st.ablate_frame_updates:
            return ScalarVector(s, new_vector) if v_out else s

        vdf = self.vector_down_frames(new_vector if v_out else vector_rep)
        merged = torch.cat([s, scalarize(vdf, frames, frame_mask, st.enable_e3_equivariance)], dim=-1)
        s = self.scalar_out_frames(merged)
        if not v_out:
            return act_s(torch.zeros_like(s) if st.ablate_scalars else s)

        if v_in:
            v_pre = new_vector
            if st.sigma_frame_gate:
                gate = torch.sigmoid(self.vector_out_scale_sigma_frames(act_v(s)))
                new_vector = v_pre * _tile3(gate)
            elif st.frame_gate:
                gate = vectorize(self.vector_out_scale_frames(act_v(s)), frames, frame_mask)
                new_vector = v_pre * _tile3(act_v(safe_vec_norm(self.vector_up_frames(gate))))
                if st.vector_frame_residual:
                    new_vector = new_vector + v_pre
            elif not is_identity(st.vector_nonlinearity):
                new_vector = v_pre * _tile3(act_v(safe_vec_norm(v_pre)))
        s = act_s(s)
        if st.ablate_scalars:
            s = torch.zeros_like(s)
        if st.ablate_vectors:
            new_vector = torch.zeros_like(new_vector)
        return ScalarVector(s, new_vector)


GCP_CLASSES = {"GCP": GCP, "GCP2": GCP2, "GCP3": GCP3}


def make_gcp(
    input_dims: Tuple[int, int],
    output_dims: Tuple[int, int],
    cfg: ModuleCfg,
    *,
    generator: torch.Generator,
    device,
    **overrides,
) -> nn.Module:
    """Build the configured GCP variant with call-site overrides: GCP2 (LBA,
    PSR, CPD, NMS, RS), GCP3 (EQ, AR) or GCP v1 (``selected_GCP`` ``GCP``)."""
    if cfg.selected_gcp not in GCP_CLASSES:
        raise ValueError(f"unknown GCP variant {cfg.selected_gcp!r}; the family is {sorted(GCP_CLASSES)}")
    settings = GCPSettings.from_cfg(cfg, **overrides)
    return GCP_CLASSES[cfg.selected_gcp](input_dims, output_dims, settings, generator=generator, device=device)
