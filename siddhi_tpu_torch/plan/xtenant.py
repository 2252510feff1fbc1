"""Cross-tenant super-dispatch — constants and an always-off packer.

Counterpart of ``siddhi_tpu/plan/xtenant.py``, which gangs small pattern
automata of different apps into one launch.  The pattern path is a later
slice of the torch port, so nothing registers here yet: the packer keeps
its read surface (snapshot and /metrics lines for ``service/rest.py`` and
``core/statistics.py``) and reports itself disabled.
"""
from __future__ import annotations

from typing import Any, Dict, List

XTENANT_ENV = "SIDDHI_TPU_XTENANT"
BUCKET_CAP_ENV = "SIDDHI_TPU_XTENANT_BUCKET"
DEFAULT_BUCKET_CAP = 32


class TenantPacker:
    """Packer that never packs (no device pattern path to pack yet)."""

    def snapshot(self) -> Dict[str, Any]:
        return {"enabled": False, "tenants_total": 0, "buckets": [],
                "reason": "cross-tenant packing not yet ported to the "
                          "torch backend"}

    def prometheus_lines(self) -> List[str]:
        return []


_PACKER = TenantPacker()


def tenant_packer() -> TenantPacker:
    return _PACKER


#: HELP/TYPE headers for the packer series (statistics.prometheus_text)
XTENANT_TYPES = [
    ("siddhi_xtenant_tenants", "gauge",
     "Automata currently packed into a cross-tenant dispatch bucket"),
    ("siddhi_xtenant_deferred_blocks_total", "counter",
     "Per-tenant blocks queued for a shared gang dispatch"),
    ("siddhi_xtenant_gang_flushes_total", "counter",
     "Gang launches: ONE device dispatch stepping every pending tenant "
     "in the bucket"),
    ("siddhi_xtenant_egress_d2h_total", "counter",
     "Shared egress-slab device-to-host reads per bucket"),
]
