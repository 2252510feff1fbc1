"""Cross-tenant super-dispatch: many apps, one launch.

Counterpart of ``siddhi_tpu/plan/xtenant.py``.  A service hosts hundreds
of tenant apps whose pattern automata are individually tiny, and each
one would pay its own block step, compaction and egress read per ingest
block.  The packer consolidates them across apps and query kinds:

  - a process-level :class:`TenantPacker` buckets eligible automata by
    shape class (state count S, slot capacity K, partitions P, batch B,
    capture rows/cols — padding only ever happens inside one tenant's
    own block, never across tenants);
  - each bucket defers submitted blocks host-side and steps every
    pending tenant in ONE gang call (``ops/nfa.nfa_gang_step_egress``):
    on CUDA one step launch per kernel template instance present and one
    compaction launch of ``csrc/nfa_gang.cu`` for the whole bucket, each
    tenant with its own condition program, block and egress cap
    (``nfa.xstep`` on the profiler); on the CPU each tenant's plain step
    and compaction in list order;
  - the gang writes every tenant's egress into ONE bucket buffer, which
    rides the bucket's :class:`~.pipeline.EgressFuser` as the flush's
    single D2H, with per-tenant row offsets.

Deferral is only transparent when the caller is already decoupled, so
the packer piggybacks on the pipelining contract (plan/pipeline.py):
with depth 0 every ingest retires inside itself, the bucket flushes
per-submit and behavior degenerates to exactly the per-app dispatches of
the unpacked path.  With depth ≥ 1 (all-@Async junctions or
``@app:pipeline('D')``) blocks from different tenants accumulate and a
repeat submission by any tenant — or any read — flushes the gang.

Grow-and-replay stays correct at bucket granularity: tenant sub-steps
inside the gang are mutually independent (separate carries, separate
blocks), so one tenant's slot overflow never corrupts co-tenants.  The
planner rewinds ONLY the overflowing tenant to its pre-gang carry
(handles carry per-tenant snapshots, the gang never writes an input
carry), grows its ring and replays through its own step; the slot
growth re-keys it into a new bucket while co-tenants' gang results
stand.

``SIDDHI_TPU_XTENANT=0`` turns the whole layer off (per-app dispatch);
``SIDDHI_TPU_XTENANT_BUCKET`` bounds tenants per bucket.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..core.lockwitness import maybe_wrap

XTENANT_ENV = "SIDDHI_TPU_XTENANT"
BUCKET_CAP_ENV = "SIDDHI_TPU_XTENANT_BUCKET"
# the dispatch win is amortized at a few dozen tenants: 100 tenants at
# cap 32 pay ceil(100/32) = 4 gang flushes per wall instead of 100
# per-app steps
DEFAULT_BUCKET_CAP = 32


def resolve_xtenant(on: Optional[bool] = None) -> bool:
    if on is None:
        raw = os.environ.get(XTENANT_ENV, "").strip().lower()
        return raw not in ("0", "false", "off", "no")
    return bool(on)


def resolve_bucket_cap() -> int:
    try:
        return max(1, int(os.environ.get(BUCKET_CAP_ENV,
                                         str(DEFAULT_BUCKET_CAP))))
    except ValueError:
        return DEFAULT_BUCKET_CAP


def _shape_key(nfa) -> Tuple:
    """Bucket grouping key: tenants only share a gang when their core
    shapes match (S/K/P/B plus capture geometry and telemetry).  The key
    never forces padding ACROSS tenants — each sub-step runs the
    tenant's own block at its own T — it bounds what one gang call
    takes: on CUDA one K (one slot geometry) and one egress width.
    Conditions are data in each tenant's program table, so tenants whose
    condition programs differ share a bucket (a bucket with any program
    steps on the gang's build variant with them, ops/nfa
    ``nfa_gang_step_egress``)."""
    return (len(nfa.spec.units), nfa.spec.n_slots, nfa.n_partitions,
            nfa.batch_b, max(nfa.spec.n_rows, 1), max(nfa.spec.n_caps, 1),
            bool(nfa.spec.telemetry))


def _gang_sig(nfa) -> Tuple:
    """Per-tenant gang signature, as the JAX package keys its gang
    executables: the tenant, its K and P and its egress cap; a change
    builds (registers) another gang, a ``rebucket`` compile row."""
    return (nfa._xt_id, nfa.spec.n_slots, nfa.n_partitions,
            int(getattr(nfa, "_egress_cap", 1024)))


def _build_gang(nfas: List[Any], trigger: str = "build"):
    """ONE call stepping every tenant's block against its own carry and
    compacting its egress into one bucket buffer (ops/nfa
    ``nfa_gang_step_egress``: the gang kernels on CUDA, each tenant's
    plain step and compaction on the CPU), registered under its shape
    class ``nfa.xstep`` and counted by the profiler as one dispatch."""
    from ..core.profiling import wrap_kernel
    from ..ops.nfa import GangTenant, nfa_gang_step_egress
    from .shapes import shape_registry
    caps = [int(getattr(n, "_egress_cap", 1024)) for n in nfas]
    B = nfas[0].batch_b

    def gang(carries, blocks, segs):
        return nfa_gang_step_egress(
            [GangTenant(n.spec, c, b, n.kprog, cap, seg)
             for n, c, b, cap, seg in zip(nfas, carries, blocks, caps,
                                          segs)], B)

    def batch_of(carries, blocks, segs):
        return sum(int(b["__ts"].numel()) for b in blocks if "__ts" in b)

    def ticks_of(carries, blocks, segs):
        Bt = max(max((n.batch_b for n in nfas), default=1), 1)
        t = max((int(b["__ts"].shape[-1]) for b in blocks
                 if "__ts" in b), default=0)
        return (-(-t // Bt), Bt)

    # shape-class dims: the bucket's shared shape key (every co-ganged
    # tenant matches it — see _shape_key) plus the gang's width and
    # per-tenant egress caps
    n0 = nfas[0]
    dims = {"S": len(n0.spec.units), "K": n0.spec.n_slots,
            "P": n0.n_partitions, "B": max(n0.batch_b, 1),
            "R": max(n0.spec.n_rows, 1), "C": max(n0.spec.n_caps, 1),
            "telem": bool(n0.spec.telemetry), "n": len(nfas),
            "caps": tuple(caps), "device": n0.device.type}
    rj = shape_registry().jit("nfa.xstep", dims, gang, trigger=trigger)
    return wrap_kernel("nfa.xstep", rj,
                       batch_of=batch_of, ticks_of=ticks_of), caps


class _TenantSlice:
    """One tenant's share of a flush's bucket buffer: ``fetch()`` returns
    ``[its egress rows (+ its telemetry)]`` as host arrays, the bucket's
    one D2H made by whichever tenant reads first."""

    __slots__ = ("source", "lo", "hi", "telem")

    def __init__(self, source, lo: int, hi: int, telem: Optional[int]):
        self.source = source
        self.lo, self.hi, self.telem = lo, hi, telem

    def fetch(self) -> List[Any]:
        got = self.source.fetch()
        out = [got[0][self.lo:self.hi]]
        if self.telem is not None:
            out.append(got[self.telem])
        return out


class _BucketCopy:
    """The bucket buffer's D2H when egress fusion is off: one HostCopy a
    flush, waited on once."""

    __slots__ = ("copy", "host", "bucket")

    def __init__(self, bufs, bucket):
        from .pipeline import HostCopy
        self.copy = HostCopy(bufs)
        self.host = None
        self.bucket = bucket

    def fetch(self) -> List[Any]:
        if self.host is None:
            from ..core.ledger import ledger
            from ..core.profiling import profiler
            with ledger().span("egress_d2h"):
                self.host = self.copy.wait()
            self.bucket.d2h_total += 1
            profiler().record_d2h("nfa.xstep", self.host[0].nbytes)
        return self.host


class TenantBucket:
    """One shape class of packed tenants.  All mutation happens under
    the owning packer's lock; flushes step every pending tenant with one
    gang launch and seal one shared egress slab."""

    def __init__(self, packer: "TenantPacker", key: Tuple):
        from .pipeline import EgressFuser, resolve_egress_fuse
        self.packer = packer
        self.key = key
        S, K, P, B = key[0], key[1], key[2], key[3]
        self.label = f"S{S}K{K}P{P}B{B}"
        self.tenants: List[Any] = []
        self.pending: List[Tuple[Any, Dict, Dict]] = []  # (nfa, block, h)
        self._pending_ids: set = set()
        # cross-tenant fused egress: every co-scheduled tenant's match
        # buffer rides one slab, sealed explicitly at end of flush
        self.fuser = (EgressFuser(f"xtenant:{self.label}")
                      if resolve_egress_fuse() else None)
        self._gangs: Dict[Tuple, Tuple[Any, List[int]]] = {}
        self.deferred_total = 0
        self.flush_total = 0
        self.d2h_total = 0          # bucket reads with egress fusion off

    # ------------------------------------------------------------ pending

    def has_pending(self, nfa) -> bool:
        return id(nfa) in self._pending_ids

    def submit(self, nfa, block: Dict, ts_range) -> Dict:
        """Queue one packed block; returns the (unresolved) handle the
        planner keeps in flight.  The caller must have called
        :meth:`sync` first (dispatch_events does), so a tenant never has
        two pending blocks."""
        with self.packer._lock:
            h = {"xpend": self, "block": block, "ts_range": ts_range,
                 "base_ts": nfa.base_ts}
            self.pending.append((nfa, block, h))
            self._pending_ids.add(id(nfa))
            self.deferred_total += 1
            return h

    def sync(self, nfa) -> None:
        """Apply this tenant's pending block (by flushing the bucket)
        before any out-of-band carry access: re-submission, timer steps,
        rebase, snapshot/restore."""
        with self.packer._lock:
            if id(nfa) in self._pending_ids:
                self._flush_locked()

    def resolve(self, h: Dict) -> None:
        """Make a deferred handle retirable: if its gang step has not
        run yet, flush the bucket now (any read forces the flush)."""
        with self.packer._lock:
            if "xpend" in h:
                self._flush_locked()

    def flush(self) -> None:
        with self.packer._lock:
            self._flush_locked()

    # ------------------------------------------------------------ the gang

    def _flush_locked(self) -> None:
        entries = self.pending
        if not entries:
            return
        self.pending = []
        self._pending_ids = set()
        nfas = [e[0] for e in entries]
        sig = tuple(_gang_sig(n) for n in nfas)
        cached = self._gangs.get(sig)
        if cached is None:
            # a second gang build on a live bucket means membership or a
            # tenant's shape re-keyed — that is a rebucket, not a build
            cached = self._gangs[sig] = _build_gang(
                nfas, trigger="build" if not self._gangs else "rebucket")
        gang, caps = cached
        # per-tenant pre-gang snapshots: the gang never writes an input
        # carry, so the planner's grow-and-replay can rewind ONE tenant
        # without re-stepping (or corrupting) its co-tenants
        pres = [(n.carry, n.base_ts) for n in nfas]
        blocks = [n.to_device(e[1]) for n, e in zip(nfas, entries)]
        news, ge = gang([n.carry for n in nfas], blocks,
                        [n._egress_seg for n in nfas])
        self.flush_total += 1
        bufs = [ge.buf]
        tele_at: List[Optional[int]] = []
        for n, c in zip(nfas, news):
            tele = c.get("telem") if n.spec.telemetry else None
            tele_at.append(len(bufs) if tele is not None else None)
            if tele is not None:
                bufs.append(tele)
        if self.fuser is not None:
            # every co-scheduled tenant's egress rides the one bucket
            # buffer: one registration, sealed now — one D2H a flush
            source = self.fuser.register(self, bufs)
            self.fuser.seal_block()
        else:
            source = _BucketCopy(bufs, self)
        for i, ((nfa, block, h), (pc, pb), cap) in enumerate(
                zip(entries, pres, caps)):
            nfa.carry = news[i]
            eg = ge.egress[i]
            lo = ge.offsets[i]
            h.update(fuse=_TenantSlice(source, lo, lo + cap + 2, tele_at[i]),
                     copy=None, cap=cap, seg=eg.seg, repack=eg.repack,
                     step_carry=pc, block=block, dl_base=h["base_ts"],
                     tk=(int(block["__ts"].shape[1]), nfa.spec.n_slots),
                     pre_carry=pc, pre_base=pb)
            h.pop("xpend", None)


class TenantPacker:
    """Process-level registry of packed automata.  One lock guards all
    buckets (submit/flush/evict are short host-side sections; the gang
    launches themselves are asynchronous on the card).  Lock order: packer → fuser —
    never the reverse, and never a query lock from under it."""

    def __init__(self):
        self._lock = maybe_wrap(threading.RLock(),
                                "plan.xtenant.TenantPacker._lock")
        self.buckets: Dict[Tuple, List[TenantBucket]] = {}
        self._next_id = 0
        self.tenants_total = 0

    # ------------------------------------------------------------ membership

    def register(self, nfa, app: str = "", query: str = "") -> bool:
        """Adopt an eligible automaton into a bucket.  Eligible means live
        and replayable (the gang never writes an input carry; a tenant
        that could not rewind could never replay alone).  Returns False
        when packing is off or the NFA does not qualify."""
        if not resolve_xtenant():
            return False
        if nfa.statically_dead or not nfa.replayable:
            return False
        if getattr(nfa, "_tenant_bucket", None) is not None:
            return True
        with self._lock:
            nfa._xt_id = self._next_id
            self._next_id += 1
            nfa._xt_label = f"{app}/{query}" if query else (app or
                                                            f"t{nfa._xt_id}")
            if not hasattr(nfa, "_egress_cap"):
                nfa._egress_cap = 1024
            self._place_locked(nfa)
            self.tenants_total += 1
        return True

    def _place_locked(self, nfa) -> None:
        key = _shape_key(nfa)
        cap = resolve_bucket_cap()
        row = self.buckets.setdefault(key, [])
        for b in row:
            if len(b.tenants) < cap:
                bucket = b
                break
        else:
            bucket = TenantBucket(self, key)
            row.append(bucket)
        bucket.tenants.append(nfa)
        nfa._tenant_bucket = bucket

    def evict(self, nfa) -> None:
        """Remove a tenant (app shutdown).  Its pending block — and only
        a whole-bucket flush can apply it — is stepped first, so
        co-tenants keep byte-identical carries and the leaver's final
        matches still retire normally."""
        bucket = getattr(nfa, "_tenant_bucket", None)
        if bucket is None:
            return
        with self._lock:
            if bucket.has_pending(nfa):
                bucket._flush_locked()
            if nfa in bucket.tenants:
                bucket.tenants.remove(nfa)
            nfa._tenant_bucket = None
            self.tenants_total -= 1
            if not bucket.tenants:
                row = self.buckets.get(bucket.key, [])
                if bucket in row:
                    row.remove(bucket)
                if not row:
                    self.buckets.pop(bucket.key, None)

    def rebucket(self, nfa) -> None:
        """Re-key a tenant whose shape changed (slot-ring growth,
        partition growth, snapshot restore): its old gang signatures are
        stale and its shape class may differ.  Callers flush first
        (grow/restore paths do); a stray pending block is flushed here."""
        bucket = getattr(nfa, "_tenant_bucket", None)
        if bucket is None:
            return
        with self._lock:
            if bucket.has_pending(nfa):
                bucket._flush_locked()
            if nfa in bucket.tenants:
                bucket.tenants.remove(nfa)
            if not bucket.tenants:
                row = self.buckets.get(bucket.key, [])
                if bucket in row:
                    row.remove(bucket)
                if not row:
                    self.buckets.pop(bucket.key, None)
            self._place_locked(nfa)

    # ------------------------------------------------------------ reads

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            rows = []
            for row in self.buckets.values():
                for b in row:
                    rows.append({
                        "bucket": b.label,
                        "tenants": [getattr(n, "_xt_label", "?")
                                    for n in b.tenants],
                        "deferred_total": b.deferred_total,
                        "flush_total": b.flush_total,
                        "egress_d2h": (b.fuser.d2h_count
                                       if b.fuser is not None
                                       else b.d2h_total),
                    })
            return {"enabled": resolve_xtenant(),
                    "tenants_total": self.tenants_total, "buckets": rows}

    def prometheus_lines(self) -> List[str]:
        from ..core.statistics import _fmt_labels
        out: List[str] = []
        with self._lock:
            for row in self.buckets.values():
                for b in row:
                    lb = _fmt_labels({"bucket": b.label})
                    out.append(
                        f"siddhi_xtenant_tenants{lb} {len(b.tenants)}")
                    out.append(f"siddhi_xtenant_deferred_blocks_total{lb} "
                               f"{b.deferred_total}")
                    out.append(f"siddhi_xtenant_gang_flushes_total{lb} "
                               f"{b.flush_total}")
                    if b.fuser is not None:
                        out.append(f"siddhi_xtenant_egress_d2h_total{lb} "
                                   f"{b.fuser.d2h_count}")
        return out


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
