"""Multi-host key routing: which process owns a partition key.

Counterpart of the routing half of ``siddhi_tpu/parallel/multihost.py``
(shared-nothing key sharding: every process runs the same partitioned
app, and a hash of the partition key routes each event to exactly one
owning process).  The owner is the canonical FNV-1a of
parallel/shards.py, so a fronting router computes process and shard
from one hash.  The multi-process runtime itself (``MultiHostAppRuntime``
and its stats all-reduce, on ``torch.distributed``) is not ported yet.
"""
from __future__ import annotations

from typing import Dict

from .shards import fnv1a


def partition_key_attrs(app) -> Dict[str, str]:
    """stream id → partition key attribute (``partition with (attr of
    Stream)``) — the router's shard key.  Two partitions keying the SAME
    stream on DIFFERENT attributes cannot share one shard route: every
    process would need every event, defeating the shared-nothing split —
    reject loudly instead of silently dropping matches."""
    from ..query_api.query import Partition, ValuePartitionType
    from ..query_api.expression import Variable
    from ..utils.errors import SiddhiAppCreationError
    out: Dict[str, str] = {}
    for el in app.execution_elements:
        if not isinstance(el, Partition):
            continue
        for pt in el.partition_types:
            if isinstance(pt, ValuePartitionType) and \
                    isinstance(pt.expression, Variable):
                attr = pt.expression.attribute
                prev = out.get(pt.stream_id)
                if prev is not None and prev != attr:
                    raise SiddhiAppCreationError(
                        f"multi-host routing: stream '{pt.stream_id}' is "
                        f"partitioned by both '{prev}' and '{attr}' — "
                        "one shard key per stream is required")
                out[pt.stream_id] = attr
    return out


def owner_of(key, num_processes: int) -> int:
    """Stable key → owning process: the CANONICAL FNV-1a over
    ``str(key)`` UTF-8 bytes (parallel/shards.fnv1a), so every host
    computes the same answer with no coordination — and the same hash
    the partition shard router uses, so a fronting router can compute
    both process and shard from one pass.  tests/test_shards.py pins
    literal vectors so the assignment can never silently shift."""
    return fnv1a(key) % num_processes
