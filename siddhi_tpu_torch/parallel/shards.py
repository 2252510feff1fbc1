"""Partition-axis shard-out: consistent key→shard routing and per-shard
engine clones.

Counterpart of ``siddhi_tpu/parallel/shards.py``.  The canonical FNV-1a
routing, ``split_rows``, ``resolve_shards`` and ``routing_digest`` are
copied unchanged: the assignment is part of the checkpoint contract (a
per-shard snapshot only restores if every key still routes to the same
shard), so the two packages must agree bit for bit.

With ``SIDDHI_TPU_SHARDS=N`` (N >= 2) a keyed device runtime
(plan/planner.py) splits its key space over N :class:`EngineShard` objects.
Each owns an engine clone, its key→lane map, its in-flight queue and its
grow-and-replay bookkeeping, so a hot shard grows and replays alone.
Every shard of a CUDA runtime lives on the runtime's card (all four on
``cuda:0`` on one H100: placing shards across cards is the multi-device
work that waits with the mesh); a CPU runtime labels shard i
``cpu:i``, the host's counterpart of the JAX package's virtual CPU
devices.  No step reduces across shards: the per-shard stats rows are
summed on the host.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

SHARDS_ENV = "SIDDHI_TPU_SHARDS"

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_FNV_MASK = (1 << 64) - 1

_U64_OFFSET = np.uint64(_FNV_OFFSET)
_U64_PRIME = np.uint64(_FNV_PRIME)


def resolve_shards(n: Optional[int] = None) -> int:
    """Requested shard count: explicit arg wins, else ``SIDDHI_TPU_SHARDS``.
    Returns 0 (disabled) unless the resolved value is >= 2 — one shard IS
    the monolithic slab, so it routes through the unsharded path."""
    if n is None:
        raw = os.environ.get(SHARDS_ENV, "").strip().lower()
        if raw in ("", "0", "off", "false", "no"):
            return 0
        try:
            n = int(raw)
        except ValueError:
            return 0
    return int(n) if int(n) >= 2 else 0


def fnv1a(key: Any) -> int:
    """64-bit FNV-1a over the canonical ``str(key)`` UTF-8 bytes."""
    h = _FNV_OFFSET
    for b in str(key).encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _FNV_MASK
    return h


def fnv1a_vec(keys: Sequence[Any]) -> np.ndarray:
    """Vectorized :func:`fnv1a`: uint64 hash per key, one fused pass over
    the character columns; bit-identical to the scalar form for str/int
    keys."""
    arr = np.asarray(keys)
    if arr.dtype.kind != "U":
        arr = arr.astype("U")           # canonical str() form
    n = arr.shape[0]
    if n == 0:
        return np.empty(0, np.uint64)
    enc = np.char.encode(arr, "utf-8")  # S<w>, NUL-padded
    w = enc.dtype.itemsize
    h = np.full(n, _U64_OFFSET, np.uint64)
    if w == 0:                          # all-empty keys hash to the basis
        return h
    u8 = np.ascontiguousarray(enc).view(np.uint8).reshape(n, w)
    live = np.ones(n, bool)
    for i in range(w):
        byte = u8[:, i]
        live &= byte != 0               # NUL padding = end of string
        if not live.any():
            break
        mixed = (h ^ byte.astype(np.uint64)) * _U64_PRIME   # wraps mod 2^64
        h = np.where(live, mixed, h)
    return h


def owner_ids(keys: Sequence[Any], n_owners: int) -> np.ndarray:
    """Per-row owner index for a key column — one vectorized hash pass
    over the batch's DISTINCT keys (scalar hash for unsortable object
    columns; the assignment is identical)."""
    arr = np.asarray(keys)
    if arr.shape[0] == 0:
        return np.empty(0, np.int64)
    try:
        uniq, inv = np.unique(arr, return_inverse=True)
        owners_u = (fnv1a_vec(uniq) % np.uint64(n_owners)).astype(np.int64)
    except TypeError:                   # unsortable object column
        seen = {}
        owners = np.empty(arr.shape[0], np.int64)
        for i, k in enumerate(arr.tolist()):
            o = seen.get(k)
            if o is None:
                o = fnv1a(k) % n_owners
                seen[k] = o
            owners[i] = o
        return owners
    return owners_u[inv.reshape(-1)]


def split_rows(keys: Sequence[Any],
               n_shards: int) -> List[Tuple[int, np.ndarray]]:
    """Route a batch: ``[(shard_id, row_indices), ...]`` for the
    NON-EMPTY shards, in shard order.  Row indices are ascending, so
    per-key event order is preserved inside each shard's sub-block."""
    sids = owner_ids(keys, n_shards)
    order = np.argsort(sids, kind="stable")
    sorted_sids = sids[order]
    bounds = np.searchsorted(sorted_sids,
                             np.arange(n_shards + 1, dtype=np.int64))
    out = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        if hi > lo:
            out.append((s, np.sort(order[lo:hi])))
    return out


def shard_devices(n_shards: int, device: Any = "cuda") -> List[Any]:
    """The device of each shard of a runtime on ``device``: the runtime's
    own card for every shard of a CUDA runtime, ``cpu:i`` for shard i of
    a CPU runtime (tensors there all live in host memory)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu", i) for i in range(n_shards)]
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return [dev] * n_shards


class EngineShard:
    """One shard of a keyed device runtime: an engine clone plus ALL the
    per-shard mutable state (key→lane map, in-flight queue, grow-and-
    replay bookkeeping, stats counters).  The runtime never mixes state
    across EngineShards — that isolation is what makes growth and
    checkpointing shard-granular."""

    __slots__ = ("idx", "engine", "device", "key_lanes", "inflight",
                 "dropped_seen", "events", "dispatches", "grows")

    def __init__(self, idx: int, engine: Any, device: Any,
                 key_lanes: Optional[dict] = None):
        self.idx = idx
        self.engine = engine
        self.device = device
        self.key_lanes = key_lanes if key_lanes is not None else {}
        self.inflight: deque = deque()
        self.dropped_seen = 0
        self.events = 0
        self.dispatches = 0
        self.grows = 0

    def stats_row(self) -> dict:
        cap = getattr(self.engine, "n_partitions",
                      getattr(self.engine, "n_lanes", 1))
        return {"shard": self.idx, "device": str(self.device),
                "keys": len(self.key_lanes), "capacity": int(cap),
                "events": self.events, "dispatches": self.dispatches,
                "grows": self.grows}


def build_shards(template: Any, n_shards: int) -> List[EngineShard]:
    """Template engine → N EngineShards.  Shard 0 adopts the template
    itself (pinned to shard 0's device); shards 1..N-1 are fresh-state
    clones via the engine's ``clone_for_shard(device)``, which share its
    compiled programs but own their carry and growth axes."""
    devs = shard_devices(n_shards, template.device)
    template.pin_to_device(devs[0])
    shards = [EngineShard(0, template, devs[0])]
    for i in range(1, n_shards):
        shards.append(EngineShard(i, template.clone_for_shard(devs[i]),
                                  devs[i]))
    return shards


def routing_digest(n_owners: int = 8, n_keys: int = 64) -> str:
    """Stable fingerprint of the key→owner assignment over a fixed probe
    vector (carried in snapshots and schema reports, so a silent routing
    shift is caught)."""
    import hashlib
    probe = [f"key-{i}" for i in range(n_keys)] + \
        [str(i) for i in range(n_keys)]
    owners = owner_ids(np.asarray(probe), n_owners)
    return hashlib.sha256(owners.tobytes()).hexdigest()[:16]
