"""GCP layers: primitives, frames, GCP2, message passing, embedding and the
interaction layer (import the submodules directly)."""
