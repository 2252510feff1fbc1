"""Host-side event packing: a flat batch → dense ``[P, T]`` lanes.

Counterpart of ``pack_blocks`` in the JAX package's ``ops/nfa.py`` (that
module imports jax, so the port keeps its own copy).  Pure numpy: the
device runtimes hand the packed block to the device in one transfer.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def pack_blocks(partition_ids: np.ndarray, columns: Dict[str, np.ndarray],
                timestamps: np.ndarray, stream_codes: np.ndarray,
                n_partitions: int, base_ts: int = 0,
                return_rows: bool = False):
    """Scatter a flat event batch into dense [P, T] lanes (T = max events
    of any partition in the batch; padding masked invalid).  The JAX
    package's ``pad_t_pow2`` (round T up to a power of two to bound jit
    retraces) is left out: torch does not trace, and the kernels take T
    at run time.  return_rows additionally yields each input event's row
    index within its lane (for per-event output decode).

    This is the columnar replacement for the reference's per-key junction
    routing (partition/PartitionStreamReceiver.java:83-153)."""
    from ..native_ext import assign_rows
    partition_ids = np.ascontiguousarray(partition_ids, np.int32)
    row, _counts, T = assign_rows(partition_ids, n_partitions)
    block: Dict[str, np.ndarray] = {}
    for name, col in columns.items():
        out = np.zeros((n_partitions, T), np.float32)
        out[partition_ids, row] = col.astype(np.float32)
        block[name] = out
    ts = np.zeros((n_partitions, T), np.int32)
    ts[partition_ids, row] = (np.asarray(timestamps, np.int64) -
                              base_ts).astype(np.int32)
    block["__ts"] = ts
    sc = np.zeros((n_partitions, T), np.int32)
    sc[partition_ids, row] = stream_codes
    block["__stream"] = sc
    valid = np.zeros((n_partitions, T), bool)
    valid[partition_ids, row] = True
    block["__valid"] = valid
    if return_rows:
        return block, row
    return block
