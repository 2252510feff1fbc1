"""Plan-IR — a small typed summary of a *compiled* plan.

The source-level analyzer (analyzer.py) stops at the SiddhiQL AST; the
paper's compilation target — pattern queries lowered to NFA transition
tables stepped as one-hot x transition-matrix style kernels — means the
real correctness and performance surface is the compiled plan: the unit
chain ops/nfa.NfaSpec encodes, the agg/window ring slabs, the jitted
column programs.  This module extracts that surface into plain data:

  * :class:`AutomatonIR` — an explicit state/transition table derived
    from an ``NfaSpec`` unit chain (each unit is a state; edges are the
    advance/stay/fork/re-arm/accept moves the kernel's statically
    unrolled step takes), plus the capture-bank and slot-ring dims the
    cost model prices.
  * :class:`ProgramIR` — non-pattern device programs (filter column
    program, grouped/windowed agg slabs, dwin hybrid, join probe) and
    host fallbacks with their recorded reason.
  * :func:`extract_plan` — SiddhiAppRuntime -> :class:`PlanIR`.
  * :func:`PlanIR.dump` — a stable, diffable textual rendering; golden
    files under tests/golden/ pin it so planner refactors surface as
    reviewable diffs.

Deliberately imports no jax (runtime objects are inspected by attribute,
never constructed) — the verifier's jaxpr sanitizer is the only pass
that needs jax and lives in plan_verify.py behind lazy imports.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: transition labels (the "columns" of the chain automaton's table)
ADVANCE = "advance"      # condition matched -> next state
STAY = "stay"            # kleene append / absent wait keeps the slot
ACCEPT_LABEL = "accept"  # advance out of the last unit -> match emitted
REARM = "rearm"          # every-mode re-arm back to a group start
FORK = "fork"            # mid-chain every: clone re-arms while original
#                          advances (kernel alloc_clones)
EPSILON = "eps"          # min-0 kleene skipped without consuming an event


@dataclass
class StateIR:
    """One automaton state (== one NfaSpec unit)."""
    idx: int
    kind: str                      # simple | count | logical | absent
    streams: Tuple[str, ...]       # stream ids of the unit's sides
    refs: Tuple[str, ...]          # capture refs (e1, e2, ...)
    min_count: int = 1
    max_count: int = 1
    waiting_ms: int = 0
    is_and: bool = False
    cond_ops: int = 0              # expression-node count of the conditions
    rows: Tuple[int, ...] = ()     # capture rows owned by this state
    cond_ops_hoisted: int = 0      # portion of cond_ops that is capture-
    #                                free: evaluated ONCE per event in the
    #                                hoisted block-wide pass instead of
    #                                per-slot inside the scan (batch mode)


@dataclass
class AutomatonIR:
    """Explicit automaton view of one compiled pattern query.

    ``accept`` is the pseudo-state ``n_states`` (the index one past the
    last unit) — the same convention as the kernel's ``_land_static``.
    """
    query: str
    states: List[StateIR]
    transitions: List[Tuple[int, str, int]]    # (src, label, dst)
    start_states: Tuple[int, ...]
    within_ms: Optional[int]
    n_partitions: int
    n_slots: int
    n_rows: int
    n_caps: int
    n_attrs: int
    is_every: bool = False
    is_sequence: bool = False
    eps_start: bool = False
    dead_start: bool = False
    lead_absent: bool = False
    mid_every: Tuple[Tuple[int, int], ...] = ()
    tail_every_start: int = -1
    pruned_states: int = 0
    simplified_conditions: int = 0
    statically_dead: bool = False
    prune_notes: Tuple[str, ...] = ()
    egress_cap: int = 1024
    meshed: bool = False
    batch_b: int = 1              # events per scan tick (ops/nfa fatter
    #                               ticks; 1 = legacy one-event chain)
    stacked: bool = False         # pattern-bank chunks vmapped into one
    #                               super-dispatch (round 7)
    dispatches_per_block: int = 1  # device executions per ingest block
    #                                (n_chunks when sequential, 1 stacked)
    telemetry: bool = False       # opt-in on-device state telemetry leaf
    #                               (@app:statistics(telemetry='true'))
    packed: bool = False          # adopted by the cross-tenant packer
    #                               (plan/xtenant.py, round 14)
    pack_bucket: str = ""         # shape-class bucket label (e.g. S2K8P1B4)
    shards: int = 0               # partition-axis shard-out fan (round 15;
    #                               0 = monolithic single-device engine)
    shard_partitions: Tuple[int, ...] = ()  # per-shard lane capacity
    shape_class: str = ""         # canonical compile shape-class key of
    #                               the step jit (plan/shapes.py registry)

    @property
    def accept(self) -> int:
        return len(self.states)

    def as_dict(self) -> Dict[str, Any]:
        d = {
            "query": self.query, "kind": "pattern-nfa",
            "n_states": len(self.states),
            "n_slots": self.n_slots, "n_partitions": self.n_partitions,
            "n_rows": self.n_rows, "n_caps": self.n_caps,
            "within_ms": self.within_ms,
            "batch_b": self.batch_b,
            "stacked": self.stacked,
            "dispatches_per_block": self.dispatches_per_block,
            "pruned_states": self.pruned_states,
            "simplified_conditions": self.simplified_conditions,
            "statically_dead": self.statically_dead,
            "telemetry": self.telemetry,
            "packed": self.packed,
            "pack_bucket": self.pack_bucket,
        }
        if self.shards:
            d["shards"] = self.shards
            d["shard_partitions"] = list(self.shard_partitions)
        if self.shape_class:
            d["shape_class"] = self.shape_class
        return d


@dataclass
class ProgramIR:
    """A compiled non-pattern plan entry (or a recorded host fallback)."""
    query: str
    kind: str                 # filter | gagg | wagg | dwin | join | host
    backend: str              # device | hybrid | host
    reason: Optional[str] = None      # host fallback reason, if any
    dims: Dict[str, int] = field(default_factory=dict)
    state_bytes: int = 0      # persistent device state (0 for host)
    cond_ops: int = 0
    shape_class: str = ""     # canonical compile shape-class key of the
    #                           step jit (plan/shapes.py registry)

    def as_dict(self) -> Dict[str, Any]:
        d = {"query": self.query, "kind": self.kind,
             "backend": self.backend, "state_bytes": self.state_bytes}
        if self.reason:
            d["reason"] = self.reason
        if self.dims:
            d["dims"] = dict(self.dims)
        if self.shape_class:
            d["shape_class"] = self.shape_class
        return d


@dataclass
class PlanIR:
    app_name: Optional[str]
    automata: List[AutomatonIR] = field(default_factory=list)
    programs: List[ProgramIR] = field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return {"app": self.app_name,
                "automata": [a.as_dict() for a in self.automata],
                "programs": [p.as_dict() for p in self.programs]}

    # ------------------------------------------------------------ dump

    def dump(self) -> str:
        """Stable textual rendering for golden-file tests: no memory
        addresses, no timings, deterministic ordering."""
        out: List[str] = [f"plan app={self.app_name or '<unnamed>'}"]
        for a in sorted(self.automata, key=lambda x: x.query):
            flags = [f for f, on in (
                ("every", a.is_every), ("sequence", a.is_sequence),
                ("eps_start", a.eps_start), ("dead_start", a.dead_start),
                ("lead_absent", a.lead_absent), ("meshed", a.meshed),
                ("telem", a.telemetry),
                ("DEAD", a.statically_dead)) if on]
            out.append(
                f"  automaton {a.query}: states={len(a.states)} "
                f"P={a.n_partitions} K={a.n_slots} B={a.batch_b} "
                f"R={a.n_rows} C={a.n_caps} within={a.within_ms} "
                f"pruned={a.pruned_states} "
                f"stacked={int(a.stacked)} dpb={a.dispatches_per_block} "
                # rendered only when the cross-tenant packer adopted the
                # automaton, so unpacked goldens stay byte-identical
                + (f"packed={a.pack_bucket} " if a.packed else "")
                # likewise only when the partition axis is sharded out
                + (f"shards={a.shards} " if a.shards else "")
                + f"flags=[{','.join(flags)}]"
                # the compile observatory's shape-class key (rendered
                # only when the step jit went through the registry)
                + (f" shape={a.shape_class}" if a.shape_class else ""))
            for s in a.states:
                extra = ""
                if s.kind == "count":
                    mx = "inf" if s.max_count >= 0x7FFFFFFF else s.max_count
                    extra = f" <{s.min_count}:{mx}>"
                elif s.kind == "logical":
                    extra = " and" if s.is_and else " or"
                elif s.kind == "absent":
                    extra = f" for={s.waiting_ms}ms"
                out.append(
                    f"    s{s.idx} {s.kind}{extra} "
                    f"streams={','.join(s.streams)} "
                    f"refs={','.join(s.refs)} rows={list(s.rows)} "
                    f"cond_ops={s.cond_ops}")
            for (src, label, dst) in a.transitions:
                dst_s = "ACCEPT" if dst == a.accept else f"s{dst}"
                out.append(f"    s{src} --{label}--> {dst_s}")
            for note in a.prune_notes:
                out.append(f"    # prune: {note}")
        for p in sorted(self.programs, key=lambda x: (x.query, x.kind)):
            dims = " ".join(f"{k}={v}" for k, v in sorted(p.dims.items()))
            line = f"  program {p.query}: {p.kind} backend={p.backend}"
            if dims:
                line += " " + dims
            if p.reason:
                line += f" reason={p.reason!r}"
            if p.shape_class:
                line += f" shape={p.shape_class}"
            out.append(line)
        return "\n".join(out) + "\n"


# ===================================================================
# extraction: compiled objects -> IR (attribute inspection only)
# ===================================================================

def _cond_ops(filters) -> int:
    """Expression-node count of a side's filter conjunction — the cost
    model's unit of condition work."""
    from ..query_api.expression import walk
    n = 0
    for f in filters or ():
        n += sum(1 for _ in walk(f))
    return n


def automaton_ir_from_nfa(nfa, query: str) -> AutomatonIR:
    """Build the explicit automaton from a CompiledPatternNFA.

    Transition derivation mirrors the kernel (ops/nfa.py):
      * ``advance`` edges land where ``_land_static`` lands — one past
        the unit, epsilon-skipping a following min-0 kleene;
      * count units below max and absent units waiting add ``stay``
        self-loops;
      * the last advance targets the ``accept`` pseudo-state;
      * every-mode re-arms and mid-chain forks add ``rearm``/``fork``
        edges back to their group starts.
    """
    spec = nfa.spec
    units = spec.units
    S = len(units)
    cond_free = getattr(spec, "cond_free", ()) or ()
    states: List[StateIR] = []
    for i, u in enumerate(units):
        desc = nfa.units[i] if i < len(getattr(nfa, "units", ())) else None
        sides = desc.sides if desc is not None else ()
        rows = tuple(s.row for s in sides if s.row >= 0)
        states.append(StateIR(
            idx=i, kind=u.kind,
            streams=tuple(s.stream_id for s in sides) or ("?",),
            refs=tuple(s.ref for s in sides) or ("?",),
            min_count=u.min_count, max_count=u.max_count,
            waiting_ms=u.waiting_ms, is_and=u.is_and,
            cond_ops=sum(_cond_ops(s.filters) for s in sides),
            rows=rows,
            cond_ops_hoisted=sum(
                _cond_ops(s.filters) for s in sides
                if 0 <= getattr(s, "cond_id", -1) < len(cond_free)
                and cond_free[s.cond_id])))

    def land(j: int) -> Tuple[int, bool]:
        """(target, eps_skipped) of an advance out of unit j — the
        no-jax twin of ops/nfa._land_static."""
        t = j + 1
        eps = False
        if t < S and units[t].kind == "count" and units[t].min_count == 0:
            eps = True
            t += 1
        return t, eps

    transitions: List[Tuple[int, str, int]] = []
    for j, u in enumerate(units):
        t, eps = land(j)
        transitions.append((j, ACCEPT_LABEL if t >= S else ADVANCE, t))
        if eps:
            # the skipped min-0 kleene at j+1 stays live-appending while
            # the partial waits at t — it is reachable, via this edge
            transitions.append((j, EPSILON, t - 1))
        if u.kind == "count" and (u.max_count > 1 or u.max_count == 0):
            transitions.append((j, STAY, j))
        if u.kind == "absent":
            transitions.append((j, STAY, j))
    if spec.is_every:
        transitions.append((spec.every_group_end, REARM, 0))
    if spec.tail_every_start >= 0:
        transitions.append((S - 1, REARM, spec.tail_every_start))
    for (g0, g1) in spec.mid_every:
        transitions.append((g1, FORK, g0))

    starts = [0]
    if spec.eps_start:
        starts.append(1)
    report = getattr(nfa, "prune_report", None) or {}
    return AutomatonIR(
        query=query, states=states, transitions=transitions,
        start_states=tuple(starts), within_ms=spec.within_ms,
        n_partitions=getattr(nfa, "n_partitions", 1),
        n_slots=spec.n_slots, n_rows=spec.n_rows, n_caps=spec.n_caps,
        n_attrs=len(spec.attr_names),
        is_every=spec.is_every, is_sequence=spec.is_sequence,
        eps_start=spec.eps_start, dead_start=spec.dead_start,
        lead_absent=spec.lead_absent, mid_every=tuple(spec.mid_every),
        tail_every_start=spec.tail_every_start,
        pruned_states=int(report.get("pruned_states", 0)),
        simplified_conditions=int(report.get("simplified", 0)),
        statically_dead=bool(getattr(nfa, "statically_dead", False)),
        stacked=bool(getattr(nfa, "_stacked", False)),
        dispatches_per_block=int(getattr(nfa, "_dispatches_per_block", 1)),
        prune_notes=tuple(report.get("notes", ())),
        egress_cap=int(getattr(nfa, "_egress_cap", 1024)),
        meshed=getattr(nfa, "mesh", None) is not None,
        batch_b=max(int(getattr(nfa, "batch_b", 1)), 1),
        telemetry=bool(getattr(spec, "telemetry", False)),
        packed=getattr(nfa, "_tenant_bucket", None) is not None,
        pack_bucket=getattr(getattr(nfa, "_tenant_bucket", None),
                            "label", ""),
        shape_class=_shape_class_of(getattr(nfa, "_step", None)))


def _shape_class_of(step) -> str:
    """Shape-class signature of a (possibly profiler-wrapped) registered
    jit, or '' — attribute inspection only, tolerant of unrouted fns."""
    rj = getattr(step, "fn", step)          # unwrap ProfiledKernel
    entry = getattr(rj, "entry", None)
    return getattr(entry, "signature", "") or ""


def _array_bytes(obj) -> int:
    """Total nbytes of array leaves in a carry dict/namedtuple/sequence —
    the shape-derived persistent footprint of a compiled program."""
    total = 0
    stack = [obj]
    while stack:
        a = stack.pop()
        if a is None:
            continue
        if isinstance(a, dict):
            stack.extend(a.values())
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
        elif hasattr(a, "_fields"):             # NamedTuple carries
            stack.extend(getattr(a, f) for f in a._fields)
        elif hasattr(a, "nbytes"):
            total += int(a.nbytes)
    return total


def _program_ir(qr, qname: str) -> ProgramIR:
    """Non-pattern query runtime -> ProgramIR (duck-typed on the device
    runtime classes so this module never imports the jax-heavy plan/*)."""
    dev = getattr(qr, "device_runtime", None)
    cls = type(dev).__name__ if dev is not None else ""
    if cls == "DeviceFilterRuntime":
        slanes = getattr(dev, "_slanes", None)
        n_str = len(slanes.lane_names()) if slanes is not None and \
            getattr(slanes, "any", False) else 0
        return ProgramIR(
            query=qname, kind="filter", backend="device",
            dims={"n_outputs": len(getattr(dev, "outputs", ())),
                  "n_numeric": len(getattr(dev, "numeric", ())),
                  "n_str_lanes": n_str},
            state_bytes=0,      # stateless program
            shape_class=_shape_class_of(getattr(dev, "_program", None)))
    if cls == "DeviceGroupedAggRuntime":
        cga = dev.cga
        shards = getattr(dev, "shards", None)
        if shards:
            # sharded runtime: total capacity and carry bytes across the
            # per-device engines (dims stay flat ints for goldens)
            return ProgramIR(
                query=qname, kind="gagg", backend="device",
                dims={"n_lanes": sum(int(sh.engine.n_lanes)
                                     for sh in shards),
                      "shards": len(shards)},
                state_bytes=sum(_array_bytes(getattr(sh.engine, "carry",
                                                     None))
                                for sh in shards),
                shape_class=_shape_class_of(
                    getattr(shards[0].engine, "_step", None)))
        return ProgramIR(
            query=qname, kind="gagg", backend="device",
            dims={"n_lanes": int(getattr(cga, "n_lanes", 1))},
            state_bytes=_array_bytes(getattr(cga, "carry", None)),
            shape_class=_shape_class_of(getattr(cga, "_step", None)))
    if cls == "DeviceWindowedAggRuntime":
        cwa = dev.cwa
        shards = getattr(dev, "shards", None)
        if shards:
            return ProgramIR(
                query=qname, kind="wagg", backend="device",
                dims={"n_partitions": sum(int(sh.engine.n_partitions)
                                          for sh in shards),
                      "shards": len(shards)},
                state_bytes=sum(_array_bytes(getattr(sh.engine, "carry",
                                                     None))
                                for sh in shards),
                shape_class=_shape_class_of(
                    getattr(shards[0].engine, "_step", None)))
        return ProgramIR(
            query=qname, kind="wagg", backend="device",
            dims={"n_partitions": int(getattr(cwa, "n_partitions", 1))},
            state_bytes=_array_bytes(getattr(cwa, "carry", None)),
            shape_class=_shape_class_of(getattr(cwa, "_step", None)))
    if getattr(qr, "join_runtime", None) is not None and \
            getattr(qr.join_runtime, "device_probe", None) is not None:
        return ProgramIR(query=qname, kind="join", backend="device",
                         dims={}, state_bytes=0,
                         shape_class=_shape_class_of(
                             getattr(qr.join_runtime, "_probe_jit", None)))
    dwin = [w for w in getattr(qr, "windows", ())
            if type(w).__name__ == "DeviceWindowProcessor"]
    if dwin:
        w = dwin[0]
        steps = getattr(w, "_steps", None) or {}
        first = steps[min(steps)] if steps else None   # built lazily per T
        return ProgramIR(
            query=qname, kind="dwin", backend="hybrid",
            reason=getattr(qr, "backend_reason", None),
            dims={"window": int(getattr(w, "length", 0) or 0)},
            state_bytes=_array_bytes(getattr(w, "carry", None)),
            shape_class=_shape_class_of(first))
    return ProgramIR(query=qname, kind="host", backend="host",
                     reason=getattr(qr, "backend_reason", None))


def extract_plan(rt) -> PlanIR:
    """SiddhiAppRuntime -> PlanIR.  Pure attribute inspection: safe to
    call on any built runtime, device-backed or host-only."""
    plan = PlanIR(app_name=getattr(rt, "name", None))

    def add_query(qr, qname: str) -> None:
        dev = getattr(qr, "device_runtime", None)
        if type(dev).__name__ == "DevicePatternRuntime":
            ir = automaton_ir_from_nfa(dev.nfa, qname)
            shards = getattr(dev, "shards", None)
            if shards:
                ir.shards = len(shards)
                ir.shard_partitions = tuple(
                    int(sh.engine.n_partitions) for sh in shards)
            plan.automata.append(ir)
        else:
            plan.programs.append(_program_ir(qr, qname))

    for qname, qr in getattr(rt, "query_runtimes", {}).items():
        add_query(qr, qname)
    for pr in getattr(rt, "partition_runtimes", ()):
        pname = getattr(pr, "name", "partition")
        if getattr(pr, "device_mode", False):
            for qname, qr in pr.device_query_runtimes.items():
                add_query(qr, f"{pname}/{qname}")
        else:
            reason = getattr(pr, "fallback_reason", None) or \
                "host partition clones"
            part = getattr(pr, "partition", None)
            for i, q in enumerate(getattr(part, "queries", ()) or ()):
                qn = getattr(q, "name", None) or f"query_{i}"
                plan.programs.append(ProgramIR(
                    query=f"{pname}/{qn}", kind="host", backend="host",
                    reason=reason))
    return plan
