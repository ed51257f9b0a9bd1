"""Typed config schema mirroring the four-level model config tree
(configs/model/{model_cfg,module_cfg,layer_cfg{mp_cfg}}; SURVEY.md §2.7).

The port's own copy of ``gcpnet_tpu/config/schema.py``, kept field for
field identical so one config describes both packages.  Frozen
dataclasses, so they are hashable and safe to share between modules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of ``d`` that ``cls`` has, a string read for a float field
    made a float (YAML 1.1 reads ``1e-2`` as a string)."""
    defaults = {f.name: f.default for f in dataclasses.fields(cls)}
    return {
        k: float(v) if isinstance(v, str) and isinstance(defaults[k], float) else v
        for k, v in d.items()
        if k in defaults
    }


@dataclasses.dataclass(frozen=True)
class ModuleCfg:
    """Mirrors configs/model/module_cfg/gcp_module_*.yaml."""

    selected_gcp: str = "GCP2"  # "GCP" | "GCP2" | "GCP3"
    norm_x_diff: bool = True
    scalar_gate: int = 0
    vector_gate: bool = True
    vector_residual: bool = False
    vector_frame_residual: bool = False
    frame_gate: bool = False
    sigma_frame_gate: bool = False
    scalar_nonlinearity: Optional[str] = "relu"
    vector_nonlinearity: Optional[str] = None
    bottleneck: int = 4
    vector_linear: bool = True
    vector_identity: bool = True
    default_vector_residual: bool = False
    default_bottleneck: int = 4
    node_positions_weight: float = 1.0
    ablate_frame_updates: bool = False
    ablate_scalars: bool = False
    ablate_vectors: bool = False
    ablate_x_force_update: bool = True
    enable_e3_equivariance: bool = False
    concatenate_lig_flag: bool = False
    scalar_out_nonlinearity: Optional[str] = "silu"  # GCP3 only

    @property
    def nonlinearities(self) -> Tuple[Optional[str], Optional[str]]:
        return (self.scalar_nonlinearity, self.vector_nonlinearity)

    def replace(self, **kw) -> "ModuleCfg":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModuleCfg":
        d = dict(d)
        sel = d.pop("selected_GCP", None)
        if sel is not None:
            if isinstance(sel, dict):
                sel = sel.get("_target_", "GCP2")
            d["selected_gcp"] = str(sel).rsplit(".", 1)[-1]
        d.pop("nonlinearities", None)  # derived from the two *_nonlinearity keys
        return cls(**_filter_kwargs(cls, d))


@dataclasses.dataclass(frozen=True)
class MPCfg:
    """Mirrors configs/model/layer_cfg/mp_cfg/gcp_mp_*.yaml."""

    edge_encoder: bool = False
    edge_gate: bool = False
    num_message_layers: int = 8
    message_residual: int = 0
    message_ff_multiplier: int = 1
    self_message: bool = True
    use_residual_message_gcp: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MPCfg":
        return cls(**_filter_kwargs(cls, d))


@dataclasses.dataclass(frozen=True)
class LayerCfg:
    """Mirrors configs/model/layer_cfg/gcp_interaction_layer_*.yaml."""

    pre_norm: bool = False
    num_feedforward_layers: int = 2
    dropout: float = 0.1
    nonlinearity_slope: float = 1e-2
    use_scalar_message_attention: bool = False
    aggregate_with_row: bool = False
    mp_cfg: MPCfg = dataclasses.field(default_factory=MPCfg)

    def replace(self, **kw) -> "LayerCfg":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LayerCfg":
        d = dict(d)
        mp = d.pop("mp_cfg", None)
        kwargs = _filter_kwargs(cls, d)
        if mp is not None:
            kwargs["mp_cfg"] = MPCfg.from_dict(mp)
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Mirrors configs/model/model_cfg/gcp_model_*.yaml (superset across
    tasks; unused fields default to 0/None for a given task)."""

    h_input_dim: int = 0
    chi_input_dim: int = 0
    e_input_dim: int = 0
    xi_input_dim: int = 0
    h_hidden_dim: int = 128
    chi_hidden_dim: int = 16
    e_hidden_dim: int = 32
    xi_hidden_dim: int = 4
    num_encoder_layers: int = 4
    num_decoder_layers: int = 3
    output_dim: int = 1
    output_scale_factor: int = 2
    dropout: float = 0.1
    dense_dropout: float = 0.1
    decoder_residual_updates: bool = False
    vocab_size: int = 20
    num_atom_types: int = 9
    len_tolerance: int = 5  # EQ/AR dataset knobs kept for schema parity
    max_units: int = 0
    unit: str = "edge"

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelCfg":
        return cls(**_filter_kwargs(cls, d))
