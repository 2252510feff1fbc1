"""Incremental aggregation on device — not yet ported to the torch backend.

Counterpart of ``siddhi_tpu/plan/iagg_compiler.py``.  The app runtime
treats ``TypeError`` from this constructor as "unsupported shape" and
builds the host aggregation cascade instead, so ``define aggregation``
keeps running on the host, as it does in the JAX package when the slab
path does not apply.
"""
from __future__ import annotations


class DeviceAggregationRuntime:
    """Placeholder: always declines, so the host cascade is built."""

    backend = "device"

    def __init__(self, definition, app_runtime):
        raise TypeError(
            "device incremental aggregation not yet ported to the torch "
            "backend")
