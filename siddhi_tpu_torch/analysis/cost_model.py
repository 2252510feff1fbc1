"""Static cost model over the Plan-IR: HBM footprint + FLOP estimates.

Prices a compiled plan BEFORE any event is ingested:

  * **HBM state bytes** — the persistent device arrays a plan keeps
    alive between steps.  For pattern automata the formulas mirror
    ``ops/nfa.make_carry`` exactly (slot rings, capture banks, per-kind
    extras), so the prediction is checked byte-exact against the real
    carry in tests/test_plan_verify.py and against the KernelProfiler's
    ``live_bytes`` gauge in bench.py (predicted-vs-measured columns).
  * **FLOPs per event** — a coarse per-ingested-event work estimate:
    every live slot of a lane evaluates each unit's condition program,
    so cost scales with (condition ops x slot ring width) summed over
    the chain.  Good for ranking plans and flagging compute-bound
    shapes, not for cycle accounting.

Diagnostics (stable codes in diagnostics.CATALOG):
  PC001 info   — per-app cost summary (bytes + flops/event in extra)
  PC002 warn   — predicted HBM exceeds a configured budget
  PC003 warn   — per-event FLOP estimate above threshold

No jax imports: everything is arithmetic over Plan-IR dims.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .diagnostics import Diagnostic
from .plan_ir import AutomatonIR, PlanIR

I32 = 4
F32 = 4

#: FLOP model coefficients: each expression node in a condition costs
#: about this many device ops per evaluated slot ...
_OPS_PER_COND_NODE = 4
#: ... plus fixed per-unit advance/bookkeeping work per slot.
_UNIT_OVERHEAD_OPS = 16

#: default PC003 threshold — a per-event estimate above this means the
#: step is compute-bound far below ingest capability on current TPUs
DEFAULT_FLOPS_WARN = 1_000_000


def nfa_state_bytes(a: AutomatonIR,
                    n_partitions: Optional[int] = None
                    ) -> Dict[str, int]:
    """Per-array persistent carry bytes of a pattern automaton — the
    exact shapes ``ops/nfa.make_carry`` allocates (kept in lockstep; the
    equivalence is asserted in tests)."""
    P = n_partitions if n_partitions is not None else a.n_partitions
    K = a.n_slots
    R = max(a.n_rows, 1)
    C = max(a.n_caps, 1)
    kinds = {s.kind for s in a.states}
    # NOTE: the fatter-tick restructuring (batch_b > 1) adds NO persistent
    # arrays — hoisted gate tensors ([T, n_free] per block) are transient
    # scan inputs, so the byte-exact contract below is unchanged.
    b: Dict[str, int] = {
        "slot_state": P * K * I32,
        "slot_start": P * K * I32,
        "slot_enter": P * K * I32,
        "slot_seq": P * K * I32,
        "arm_seq": P * I32,
        "captures": P * K * R * C * F32,
        "dropped": P * I32,
    }
    if "count" in kinds:
        b["cnt_cur"] = P * K * I32
        b["cnt_prev"] = P * K * I32
    if a.eps_start and a.is_sequence:
        b["seq_froze"] = P * I32
    if "logical" in kinds:
        b["lmask"] = P * K * I32
    if "absent" in kinds:
        b["deadline"] = P * K * I32
    arm_once = (not a.is_every) or \
        (not a.is_sequence and a.states and a.states[0].kind == "count")
    if arm_once:
        b["armed_total"] = P * I32
    if a.telemetry:
        # [occ[S] ‖ gate_pass[S] ‖ gate_fail[S] ‖ within_drops] per
        # partition (@app:statistics(telemetry='true'), ops/nfa.make_carry)
        b["telem"] = P * (3 * len(a.states) + 1) * I32
    return b


def nfa_egress_bytes(a: AutomatonIR) -> int:
    """Per-chunk compacted-egress buffer: (cap+1) x (4 + R*C) int32."""
    R = max(a.n_rows, 1)
    C = max(a.n_caps, 1)
    return (a.egress_cap + 1) * (4 + R * C) * I32


def nfa_flops_per_event(a: AutomatonIR) -> int:
    """Per-ingested-event condition work.

    Legacy one-event ticks (batch_b == 1): every slot of the event's
    lane evaluates each unit's condition program each step.  With the
    fatter-tick restructuring (batch_b > 1, ops/nfa round 6) the
    capture-free portion of each condition is HOISTED out of the scan and
    evaluated once per event instead of once per (event, slot) — the
    formula mirrors the real step: hoisted ops cost x1, the residual
    per-slot ops and fixed unit bookkeeping still cost x n_slots."""
    per_event = 0
    for s in a.states:
        hoisted = min(s.cond_ops_hoisted, s.cond_ops) \
            if a.batch_b > 1 else 0
        per_event += hoisted * _OPS_PER_COND_NODE
        per_event += ((s.cond_ops - hoisted) * _OPS_PER_COND_NODE +
                      _UNIT_OVERHEAD_OPS) * a.n_slots
    return per_event


def bank_state_bytes(a: AutomatonIR, n_patterns: int,
                     n_partitions: Optional[int] = None) -> int:
    """A CompiledPatternBank carries the same arrays with a leading
    pattern axis (ops/nfa.make_bank_carry broadcasts, the first donated
    step materializes them dense)."""
    return n_patterns * sum(nfa_state_bytes(a, n_partitions).values())


def stacked_bank_state_bytes(a: AutomatonIR, n_chunks: int, chunk: int,
                             n_partitions: Optional[int] = None) -> int:
    """The stacked super-dispatch carry ([C, N, ...], one array per
    leaf) holds exactly the same elements as C separate [N, ...] chunk
    carries — stacking changes dispatch count, never bytes.  Asserted
    against both ``bank_state_bytes`` and the real stacked carry in
    tests/test_dispatch_stack.py."""
    return n_chunks * bank_state_bytes(a, chunk, n_partitions)


def packed_bucket_state_bytes(autos: "List[AutomatonIR]") -> int:
    """Persistent carry bytes of one cross-tenant dispatch bucket
    (plan/xtenant.TenantBucket): tenants keep their OWN carries — the
    gang unrolls each tenant's step over its own arrays, padding only
    ever happens inside a tenant's own block — so the bucket holds
    exactly the sum of its members' individual carries.  Like stacking,
    packing changes dispatch count, never bytes; asserted against the
    live carries in tests/test_multitenant.py."""
    return sum(sum(nfa_state_bytes(a).values()) for a in autos)


def packed_bucket_egress_bytes(autos: "List[AutomatonIR]") -> int:
    """Shared egress-slab bytes of one bucket flush: the concatenated
    D2H slab is the per-tenant compacted buffers laid end to end (plus
    telemetry rows when enabled) — again a pure sum, no cross-tenant
    padding."""
    total = 0
    for a in autos:
        total += nfa_egress_bytes(a)
        if a.telemetry:
            total += a.n_partitions * (3 * len(a.states) + 1) * I32
    return total


#: Measured round 6 (docs/perf_notes.md): XLA's fusion of the hoisted
#: gate tensors back into the unrolled inner scan duplicates step
#: intermediates ~3.2x per B-doubling (cost_analysis bytes, v5e + CPU).
BATCH_FUSION_GROWTH = 3.2

#: Transient-over-carry multiplier measured on v5e at B=1 (N=1000
#: P=10k K=8 S=2 C=1 wants ~22G → ~16x the carry bytes).
SCAN_TEMP_FACTOR = 16

#: Chunk-size budget: leave headroom below ~16G HBM.
CHUNK_HBM_BUDGET = 8 << 30


def bank_chunk_bytes_per_pattern(n_partitions: int, n_slots: int,
                                 n_rows: int, n_caps: int,
                                 batch_b: int = 1,
                                 ring: bool = False) -> int:
    """Transient HBM a single bank pattern costs during one step —
    carry bytes x scan/vmap intermediate factor, doubled when a decode
    ring keeps the per-step match_caps alive, and scaled by the
    B-batching fusion duplication (~3.2x per B-doubling: B=4 ≈ 10.24x).
    ``CompiledPatternBank._default_chunk`` sizes chunks against exactly
    this formula (asserted in tests)."""
    b = n_partitions * n_slots * (
        I32 + I32 + F32 * max(n_rows, 1) * max(n_caps, 1)) * \
        SCAN_TEMP_FACTOR
    if ring:
        b *= 2
    doublings = max(int(batch_b).bit_length() - 1, 0)
    return int(b * BATCH_FUSION_GROWTH ** doublings)


def default_pattern_chunk(n_patterns: int, n_partitions: int,
                          n_slots: int, n_rows: int, n_caps: int,
                          batch_b: int = 1, ring: bool = False,
                          budget: int = CHUNK_HBM_BUDGET) -> int:
    """Largest divisor-ladder chunk whose per-step transients fit the
    HBM budget at the given batch factor."""
    per = bank_chunk_bytes_per_pattern(n_partitions, n_slots, n_rows,
                                       n_caps, batch_b, ring)
    chunk = max(1, budget // max(per, 1))
    for c in (500, 250, 200, 125, 100, 50, 25, 20, 10, 5, 4, 2, 1):
        if c <= chunk and n_patterns % c == 0:
            return c
    return 1


@dataclass
class CostEntry:
    query: str
    kind: str
    hbm_bytes: int
    flops_per_event: int
    breakdown: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"query": self.query, "kind": self.kind,
                "hbm_bytes": self.hbm_bytes,
                "flops_per_event": self.flops_per_event,
                "breakdown": dict(self.breakdown)}


@dataclass
class CostReport:
    entries: List[CostEntry] = field(default_factory=list)

    @property
    def total_hbm_bytes(self) -> int:
        return sum(e.hbm_bytes for e in self.entries)

    @property
    def total_flops_per_event(self) -> int:
        return sum(e.flops_per_event for e in self.entries)

    def as_dict(self) -> Dict[str, Any]:
        return {"total_hbm_bytes": self.total_hbm_bytes,
                "total_flops_per_event": self.total_flops_per_event,
                "entries": [e.as_dict() for e in self.entries]}


def plan_cost(plan: PlanIR) -> CostReport:
    """Price every entry of a Plan-IR.  Automata get the closed-form
    make_carry formulas; non-pattern programs carry their shape-derived
    persistent bytes from extraction (still static: array shapes are
    fixed at plan time) plus a condition-graph FLOP estimate."""
    rep = CostReport()
    for a in plan.automata:
        if a.shards:
            # partition-axis shard-out: one carry per shard, each sized
            # by its own (elastically grown) lane capacity
            bd: Dict[str, int] = {}
            for p in (a.shard_partitions or (a.n_partitions,) * a.shards):
                for k, v in nfa_state_bytes(a, n_partitions=p).items():
                    bd[k] = bd.get(k, 0) + v
        else:
            bd = nfa_state_bytes(a)
        bd["egress_buffer"] = nfa_egress_bytes(a)
        rep.entries.append(CostEntry(
            query=a.query, kind="pattern-nfa",
            hbm_bytes=sum(bd.values()),
            flops_per_event=0 if a.statically_dead
            else nfa_flops_per_event(a),
            breakdown=bd))
    for p in plan.programs:
        if p.backend == "host":
            continue
        rep.entries.append(CostEntry(
            query=p.query, kind=p.kind, hbm_bytes=p.state_bytes,
            flops_per_event=p.cond_ops * _OPS_PER_COND_NODE,
            breakdown={"state": p.state_bytes}))
    return rep


def cost_diagnostics(report: CostReport,
                     hbm_budget_mb: Optional[float] = None,
                     flops_warn: int = DEFAULT_FLOPS_WARN,
                     query: Optional[str] = None) -> List[Diagnostic]:
    """CostReport -> PC0xx diagnostics."""
    diags: List[Diagnostic] = []
    if report.entries:
        diags.append(Diagnostic(
            "PC001",
            f"plan cost: {report.total_hbm_bytes} persistent HBM bytes, "
            f"~{report.total_flops_per_event} FLOPs/event across "
            f"{len(report.entries)} device plan(s)",
            query=query,
            extra={"hbm_bytes": report.total_hbm_bytes,
                   "flops_per_event": report.total_flops_per_event}))
    if hbm_budget_mb is not None:
        budget = int(hbm_budget_mb * (1 << 20))
        if report.total_hbm_bytes > budget:
            diags.append(Diagnostic(
                "PC002",
                f"predicted persistent HBM {report.total_hbm_bytes} B "
                f"exceeds the {hbm_budget_mb} MB budget",
                query=query,
                extra={"hbm_bytes": report.total_hbm_bytes,
                       "budget_bytes": budget}))
    for e in report.entries:
        if e.flops_per_event > flops_warn:
            diags.append(Diagnostic(
                "PC003",
                f"'{e.query}' estimates ~{e.flops_per_event} FLOPs per "
                f"event (threshold {flops_warn}) — the step will be "
                f"compute-bound",
                query=e.query,
                extra={"flops_per_event": e.flops_per_event}))
    return diags
