"""Tooling: doc generation (reference: modules/siddhi-doc-gen)."""
