"""Batched NFA step — the pattern-matching hot path.

Counterpart of ``siddhi_tpu/ops/nfa.py``: the single-pattern block step
and the pattern bank's step (N patterns that differ only in their
constants, over one shared block).  The same dense program replaces the
reference's per-event, per-partial-match Java loop
(query/input/stream/state/StreamPreStateProcessor.java:292-337):

    state:    slot_state [P, K] int32   — unit each partial slot waits on
              slot_start [P, K] int32   — first-capture timestamp (within)
              captures   [P, K, R, C]   — capture rows (one per unit side)
    events:   [P, T] time-major blocks, one independent lane per partition

The JAX package runs ``lax.scan`` over T inside ``vmap`` over P, an XLA
program.  The port computes the same function two ways:

  - :func:`nfa_block_step_plain` — PyTorch over ``[P, K]`` tensors (the P
    axis written out in place of ``vmap``), a Python loop over the
    block's T events.  Every unit kind, SEQUENCE, absent states and
    telemetry.  Used for CPU tensors and by the checks.
  - the hand-written Hopper kernels ``csrc/nfa_step.cu`` — the step with
    the egress compaction fused behind it, launched by
    :func:`nfa_step_egress` for CUDA tensors, for the specs of its class
    (:func:`kernel_class_reason`): simple units, PATTERN, `every` on the
    leading unit or none, optional `within`, no telemetry.  Its
    conditions arrive as a block-wide capture-free gate per condition
    plus a table of ``<event lane> <cmp> <capture lane>`` compares and,
    in a pattern bank, of ``<event lane> <cmp> <pattern constant>``
    compares (:class:`NfaKernelProgram`, built by plan/nfa_compiler.py).  The
    dense per-(p, t, slot) outputs never reach device memory: each
    matched slot becomes one row of the egress slab.

:func:`nfa_step_egress` is the engine's entry: on the CPU it runs the
plain composition (:func:`nfa_block_step_plain`, then
:func:`egress_pack_plain`), on CUDA the kernels.  Both are functional:
the input carry is never modified, because the engine's grow-and-replay
re-runs a chunk from the pre-chunk carry.

:func:`nfa_bank_step` is the pattern bank's entry (plan/nfa_compiler.py
``CompiledPatternBank``): a carry with leading pattern axes ([N, P, ...]
or [C, N, P, ...]), one [P, T] block shared by every pattern, and each
pattern's constants as float32 parameter lanes.  On the CPU it runs
:func:`nfa_bank_step_plain` (the pattern axes flattened into the lane axis
of the plain step); on CUDA two kernels of ``csrc/nfa_step.cu``: the bank
step (per-lane match count and last match) and the match ring (each
pattern's top-``ring`` lanes and their payloads).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._kernels import load_kernel

COUNT_INF = 0x7FFFFFFF

#: B-event micro-batching of the JAX package's scan chain.  The env value
#: is B itself: unset/empty → DEFAULT_BATCH_B; ``=1`` is the kill switch
#: (legacy one-event ticks, no hoisting).  In the port B decides only
#: whether capture-free conditions are hoisted out of the event loop; the
#: results are identical either way.
BATCH_ENV = "SIDDHI_TPU_NFA_BATCH"
DEFAULT_BATCH_B = 4


def resolve_batch_b(batch_b: Optional[int] = None) -> int:
    """Effective events-per-tick B: explicit argument wins, else the
    BATCH_ENV value, else DEFAULT_BATCH_B.  Anything < 1 (or
    unparseable) clamps to the legacy/default respectively."""
    if batch_b is None:
        raw = os.environ.get(BATCH_ENV, "").strip().lower()
        if raw in ("", "on", "true", "default"):
            return DEFAULT_BATCH_B
        try:
            return max(1, int(raw))
        except ValueError:
            return DEFAULT_BATCH_B
    return max(1, int(batch_b))


#: Chunk stacking: a bank of C homogeneous-shape pattern chunks steps as
#: ONE call over a stacked [C, N, ...] carry instead of C calls.
#: ``=0``/``off`` restores the sequential chunk loop.
STACK_ENV = "SIDDHI_TPU_NFA_STACK"


def resolve_stack(stack: Optional[bool] = None) -> bool:
    """Effective chunk-stacking switch: explicit argument wins, else the
    STACK_ENV value (default on; 0/false/off disables)."""
    if stack is None:
        raw = os.environ.get(STACK_ENV, "").strip().lower()
        return raw not in ("0", "false", "off", "no")
    return bool(stack)


class UnitSpec(NamedTuple):
    """One chain position (≙ one Pre/PostStateProcessor pair)."""
    kind: str                 # 'simple' | 'count' | 'logical' | 'absent'
    stream_a: int             # stream code of side A
    cond_a: int               # index into NfaSpec.cond_fns
    row_a: int                # capture row (-1: no captures, absent units)
    stream_b: int = -1        # logical pairs only
    cond_b: int = -1
    row_b: int = -1
    is_and: bool = False      # logical: and vs or
    min_count: int = 1        # count units
    max_count: int = 1
    waiting_ms: int = 0       # absent units


class NfaSpec(NamedTuple):
    """Compiled NFA structure (built by plan/nfa_compiler.py)."""
    units: Tuple[UnitSpec, ...]
    n_rows: int                       # capture rows
    n_caps: int                       # lanes per row (C)
    n_slots: int                      # K: max concurrent partials
    within_ms: Optional[int]
    # cond_fns[i](event: {attr: [N]}, captures: [N or 1, R, C]) -> [N]
    cond_fns: Tuple[Callable, ...]
    cap_cols: Tuple[Tuple[str, ...], ...]   # per row: first bank ++ last bank
    n_first: Tuple[int, ...]          # per row: #lanes in the first bank
    n_lane: Tuple[int, ...]           # per row: __n counter lane (-1: none)
    matched_lane: Tuple[int, ...]     # per row: __matched lane (-1: none)
    attr_names: Tuple[str, ...]       # event column order
    is_every: bool
    is_sequence: bool = False
    arm_once: bool = False            # single-shot arming
    every_group_end: int = 0          # last unit of the `every` re-arm group
    tail_every_start: int = -1        # first unit of a trailing `every`
    #                                   group (`A -> every B`)
    mid_every: Tuple[Tuple[int, int], ...] = ()
    #                                   mid-chain `every` groups (g0, g1)
    eps_start: bool = False           # leading min-0 kleene start state
    n_last: Tuple[int, ...] = ()      # per row: #lanes in the last bank
    idx_banks: Tuple = ()             # per row: ((k, start, len), ...)
    lastk_banks: Tuple = ()           # per row: ((j, start), ...)
    m_src: Tuple = ()                 # per row: last-bank source lanes
    lead_absent: bool = False         # `not A for t -> ...` start state
    dead_start: bool = False          # SEQUENCE leading kleene min >= 2
    cond_free: Tuple[bool, ...] = ()  # per cond_fn: reads only the event
    batch_b: int = 0                  # events per tick (see BATCH_ENV)
    telemetry: bool = False           # int32 telemetry leaf in the carry

    @property
    def n_states(self) -> int:
        return len(self.units)


def _has(spec: NfaSpec, kind: str) -> bool:
    return any(u.kind == kind for u in spec.units)


def _land_static(spec: NfaSpec, j_from: int):
    """Where a slot advancing out of unit j_from ends up.

    Returns (target, live0, completed): `live0` marks an epsilon-skipped
    min-0 count unit at target-1 that keeps live-appending
    (CountPreStateProcessor.addState min==0 branch); `completed` means the
    chain is done and the advance emits a match."""
    S = len(spec.units)
    t = j_from + 1
    live0 = False
    if t < S and spec.units[t].kind == "count" and \
            spec.units[t].min_count == 0:
        live0 = True
        t += 1
    return t, live0, t >= S


def make_carry(spec: NfaSpec, n_partitions: int,
               device="cpu") -> Dict[str, torch.Tensor]:
    """An empty carry on ``device``: the JAX package's leaves, names,
    shapes and dtypes (analysis/cost_model.nfa_state_bytes mirrors
    them)."""
    P, K = n_partitions, spec.n_slots
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    i32 = dict(dtype=torch.int32, device=device)

    def z(*shape):
        return torch.zeros(shape, **i32)

    def neg(*shape):
        return torch.full(shape, -1, **i32)
    carry = {
        "slot_state": neg(P, K),
        "slot_start": z(P, K),
        # ts the slot entered its current unit + per-partition arm sequence
        # — together they reproduce the oracle's pending-list insertion
        # order for same-event completions
        "slot_enter": z(P, K),
        "slot_seq": z(P, K),
        "arm_seq": z(P),
        "captures": torch.zeros((P, K, R, C), dtype=torch.float32,
                                device=device),
        "dropped": z(P),                # slot-overflow counter
    }
    if _has(spec, "count"):
        carry["cnt_cur"] = z(P, K)
        carry["cnt_prev"] = neg(P, K)
    if spec.eps_start and spec.is_sequence:
        carry["seq_froze"] = z(P)
    if _has(spec, "logical"):
        carry["lmask"] = z(P, K)
    if _has(spec, "absent"):
        carry["deadline"] = z(P, K)
    if spec.arm_once:
        carry["armed_total"] = z(P)
    if spec.telemetry:
        # [occ[S] (gauge) ‖ gate_pass[S] ‖ gate_fail[S] ‖ within_drops]
        carry["telem"] = z(P, 3 * len(spec.units) + 1)
    return carry


def carry_dtype(name: str) -> torch.dtype:
    """dtype of carry leaf ``name`` (the JAX package's, x64 off)."""
    return torch.float32 if name == "captures" else torch.int32


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _count(x: torch.Tensor) -> torch.Tensor:
    """Per-lane number of True slots, int32 (jnp.sum of a bool row)."""
    return x.sum(dim=-1, dtype=torch.int32)


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Per-lane index of the first True slot, 0 if none (jnp.argmax)."""
    return x.to(torch.uint8).argmax(dim=-1)


def _event_rows(spec: NfaSpec, event) -> torch.Tensor:
    """[P, R, C] matrix of the lanes this event would write into each row
    (__matched lanes read 1.0; __n lanes are patched per-slot later)."""
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    ts = event["__ts"]
    P = ts.shape[0]
    one = torch.ones((P,), dtype=torch.float32, device=ts.device)
    zero = torch.zeros((P,), dtype=torch.float32, device=ts.device)
    rows = []
    for r in range(R):
        cols = spec.cap_cols[r] if r < len(spec.cap_cols) else ()
        lanes = [event[a].to(torch.float32) if a in event else one
                 for a in cols]
        lanes += [zero] * (C - len(lanes))
        rows.append(torch.stack(lanes, dim=-1))
    return torch.stack(rows, dim=1)


def _gate_key(i: int) -> str:
    """Event-dict column carrying cond i's hoisted block-wide gate."""
    return f"__gate_{i}"


#: event-dict column carrying the kernel model's packed gate word
KGATE = "__kgate"

#: compare-table op codes (csrc/nfa_step.cu reads the same numbering)
CMP_OPS = ("<", "<=", ">", ">=", "==", "!=")
_CMP_FNS = (torch.lt, torch.le, torch.gt, torch.ge, torch.eq, torch.ne)


class NfaKernelProgram(NamedTuple):
    """The CUDA kernel's view of a spec's conditions (built by
    plan/nfa_compiler.py).

    Per condition ``i``: ``gate_fns[i]`` is its capture-free, param-free
    part (the AND of those conjuncts, or the whole condition), a cond fn
    evaluated block-wide against zero captures; ``cmp[i]`` lists its
    conjuncts ``(attr, row, lane, op)``: event lane ``kern_attrs[attr]``
    ``CMP_OPS[op]`` capture lane ``(row, lane)``; ``pcmp[i]`` (pattern
    banks) its conjuncts ``(attr, param, op)``: event lane
    ``kern_attrs[attr]`` ``CMP_OPS[op]`` the pattern's float32 constant
    ``param_names[param]``.  ``row_src`` is, per capture lane
    ``r * C + c``, the kern_attrs index the event writes there (-1: 0.0,
    -2: 1.0).  ``reason`` names the first feature outside the kernel's
    class (None: inside)."""
    gate_fns: Tuple[Callable, ...]
    cmp: Tuple[Tuple[Tuple[int, int, int, int], ...], ...]
    kern_attrs: Tuple[str, ...]
    row_src: Tuple[int, ...]
    reason: Optional[str]
    pcmp: Tuple[Tuple[Tuple[int, int, int], ...], ...] = ()
    param_names: Tuple[str, ...] = ()


def kernel_class_reason(spec: NfaSpec) -> Optional[str]:
    """The first structural feature of ``spec`` outside the CUDA kernel's
    class, or None.  The condition forms are checked by the compiler
    (NfaKernelProgram.reason)."""
    for u in spec.units:
        if u.kind != "simple":
            return {"count": "kleene count (<m:n>) states",
                    "logical": "logical and/or states",
                    "absent": "absent (`not ... for`) states"}.get(
                        u.kind, f"{u.kind} states")
    if spec.is_sequence:
        return "SEQUENCE semantics"
    if spec.is_every and spec.every_group_end > 0:
        return "an `every` group over more than the leading state"
    if spec.mid_every:
        return "mid-chain `every`"
    if spec.tail_every_start >= 0:
        return "trailing `every`"
    if spec.telemetry:
        return "on-device telemetry"
    if len(spec.cond_fns) > 31:
        return "more than 31 conditions"
    return None


def _model_cond(kprog: NfaKernelProgram, event, i: int,
                caps: torch.Tensor) -> torch.Tensor:
    """Condition i as the kernel computes it: gate bit AND every param
    compare (the lane's pattern constants ride the event dict by name)
    AND every capture compare of its table against ``caps`` ([P, K, R,
    C], or [P, 1, R, C] zeros) → [P, K'] bool."""
    ok = ((event[KGATE] >> i) & 1).bool()[:, None]
    for attr, prm, op in (kprog.pcmp[i] if kprog.pcmp else ()):
        ok = ok & _CMP_FNS[op](event[kprog.kern_attrs[attr]],
                               event[kprog.param_names[prm]])[:, None]
    for attr, row, lane, op in kprog.cmp[i]:
        x = event[kprog.kern_attrs[attr]][:, None]
        ok = ok & _CMP_FNS[op](x, caps[:, :, row, lane])
    return ok.expand(caps.shape[0], caps.shape[1])


def _eval_cond_fn(fn, event, caps: torch.Tensor) -> torch.Tensor:
    """fn against per-lane event scalars ([P]) and slot captures
    ([P, K, R, C]) → [P, K] bool, through the flat cond-fn protocol."""
    P, K = caps.shape[0], caps.shape[1]
    flat = {a: v[:, None].expand(P, K).reshape(-1)
            for a, v in event.items()
            if not (a.startswith("__gate_") or a == KGATE)}
    out = fn(flat, caps.reshape(P * K, caps.shape[2], caps.shape[3]))
    return out.reshape(P, K)


def _eval_conds(spec: NfaSpec, event, caps, kprog=None) -> List[torch.Tensor]:
    """Per-cond [P, K] booleans for one event.

    Hoisted conditions (capture-free, precomputed for the whole block by
    ``_hoist_cond_gates``) read their gate straight from the event dict;
    everything else evaluates its program against the current captures.
    With the kernel model's packed gate word in the event, every
    condition is its gate bit AND its compare table."""
    P, K = caps.shape[0], caps.shape[1]
    conds = []
    for i, fn in enumerate(spec.cond_fns):
        if KGATE in event:
            conds.append(_model_cond(kprog, event, i, caps))
            continue
        key = _gate_key(i)
        if key in event:
            conds.append(event[key][:, None].expand(P, K))
        else:
            conds.append(_eval_cond_fn(fn, event, caps))
    return conds


def _cond_on(spec: NfaSpec, event, cond_id: int, caps,
             kprog=None) -> torch.Tensor:
    """One condition against a virgin zero-caps context ([P, 1, R, C])
    → [P].  A hoisted gate IS fn(event, zeros) by construction, so it
    substitutes exactly."""
    if KGATE in event:
        return _model_cond(kprog, event, cond_id, caps)[:, 0]
    key = _gate_key(cond_id)
    if key in event:
        return event[key]
    return _eval_cond_fn(spec.cond_fns[cond_id], event, caps)[:, 0]


def _zero_caps(spec: NfaSpec, P: int, device) -> torch.Tensor:
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    return torch.zeros((P, 1, R, C), dtype=torch.float32, device=device)


def _block_cond(fn, spec: NfaSpec, events_p: Dict[str, torch.Tensor],
                extra=None) -> torch.Tensor:
    """fn over a whole [P, T] block against zero captures → [P, T]."""
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    shape = tuple(events_p["__ts"].shape)
    ev = {k: v.reshape(-1) for k, v in events_p.items()}
    if extra:
        ev = {**ev, **extra}
    zero = torch.zeros((1, R, C), dtype=torch.float32,
                       device=events_p["__ts"].device)
    return fn(ev, zero).to(torch.bool).reshape(shape)


def _hoist_cond_gates(spec: NfaSpec, events_p: Dict[str, torch.Tensor],
                      extra: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Evaluate every capture-free condition for a whole [P, T] block in
    ONE vectorised pass outside the event loop → {__gate_i: [P, T]
    bool}.  Capture-free programs never read the slot captures, so
    evaluating them against a zero capture context is exact."""
    return {_gate_key(i): _block_cond(spec.cond_fns[i], spec, events_p,
                                      extra)
            for i, f in enumerate(spec.cond_free) if f}


def kernel_gate_word(spec: NfaSpec, kprog: NfaKernelProgram,
                     events_p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's gate input: [P, T] int32 whose bit i is condition i's
    capture-free part, evaluated block-wide by its torch program."""
    word = torch.zeros(tuple(events_p["__ts"].shape), dtype=torch.int32,
                       device=events_p["__ts"].device)
    for i, fn in enumerate(kprog.gate_fns):
        word |= _i32(_block_cond(fn, spec, events_p)) << i
    return word


def _pad_block_t(events_p: Dict[str, torch.Tensor], batch_b: int):
    """Pad the time axis up to a batch_b multiple.  Padding rows are
    invalid (__valid False — every transition/arm is gated on it) and
    repeat the LAST event's timestamp, so the only unconditional per-event
    pass (within expiry) re-runs at a time it already ran at and kills
    nothing new: the carry stays bit-identical to the unpadded loop."""
    T = int(events_p["__ts"].shape[1])
    ticks = -(-T // batch_b) if T else 0
    pad = ticks * batch_b - T
    if not pad:
        return events_p, T, ticks

    def pad_leaf(name, v):
        if name == "__ts":
            fill = v[:, T - 1:T].expand(v.shape[0], pad)
        else:
            fill = torch.zeros((v.shape[0], pad) + tuple(v.shape[2:]),
                               dtype=v.dtype, device=v.device)
        return torch.cat([v, fill], dim=1)
    return ({k: pad_leaf(k, v) for k, v in events_p.items()}, T, ticks)


class _StepState:
    """Per-event slot tensors threaded through the unit loop: [P, K]
    per slot, [P] per lane (the JAX package's per-partition [K] and
    scalars with the P axis written out)."""

    def __init__(self, spec: NfaSpec, carry: Dict, P: int, K: int, dev):
        self.spec = spec
        self.st = carry["slot_state"]
        self.start = carry["slot_start"]
        self.enter = carry["slot_enter"]
        self.seq = carry["slot_seq"]
        self.arm_seq = carry["arm_seq"]
        self.caps = carry["captures"]
        self.dropped = carry["dropped"]
        self.cnt_cur = carry.get("cnt_cur")
        self.cnt_prev = carry.get("cnt_prev")
        self.seq_froze = carry.get("seq_froze")
        self.lmask = carry.get("lmask")
        self.deadline = carry.get("deadline")
        self.armed_total = carry.get("armed_total")
        self.ar = torch.arange(K, device=dev)
        self.m_mask = torch.zeros((P, K), dtype=torch.bool, device=dev)
        self.m_ts = torch.zeros((P, K), dtype=torch.int32, device=dev)
        self.m_enter = torch.zeros((P, K), dtype=torch.int32, device=dev)
        self.m_seq = torch.zeros((P, K), dtype=torch.int32, device=dev)
        # captures snapshotted AT COMPLETION — a trailing-every re-arm may
        # clear group rows in the live slot after the match is recorded
        self.m_caps = torch.zeros_like(self.caps)
        # mid-chain `every` clone requests collected during land():
        # group start → (source mask, source rank by pre-land (enter, seq))
        self.spawn: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _pending_rank(self, pred):
        """Rank `pred` slots by their pending-list order (enter, seq) —
        the oracle's append order for re-arm clones and fork clones."""
        e, sq = self.enter, self.seq
        less = (e[:, None, :] < e[:, :, None]) | \
            ((e[:, None, :] == e[:, :, None]) &
             (sq[:, None, :] < sq[:, :, None]))
        return _count(pred[:, None, :] & less)

    def _clear_group_logical_rows(self, caps, sel_or_range, g0, g1):
        """Zero the logical-side capture rows of units[g0..g1] — the
        oracle's re-arm/fork clone clears LOGICAL sides (addEveryState);
        simple rows are overwritten on the next match and stay.
        sel_or_range: [P, K] bool (applied per-slot) or None (whole
        array)."""
        spec = self.spec
        log_rows = [r for u in spec.units[g0:g1 + 1]
                    for r in (u.row_a, u.row_b)
                    if u.kind == "logical" and r >= 0]
        if not log_rows:
            return caps
        R = caps.shape[-2]
        rm = torch.zeros((R,), dtype=torch.bool, device=caps.device)
        rm[log_rows] = True
        mask = rm[None, None, :, None]
        if sel_or_range is not None:
            mask = sel_or_range[:, :, None, None] & mask
        return torch.where(mask, torch.zeros((), device=caps.device), caps)

    def land(self, pred, j_from: int, base_ts, fwd_cnt=None, fwd_dead=None):
        """Advance `pred` slots out of unit j_from at time base_ts
        ([P, 1] event ts or [P, K] deadlines).

        fwd_cnt: forwarded count for count-unit exits (stays live unless
        fwd_dead)."""
        spec = self.spec
        t, live0, completed = _land_static(spec, j_from)
        for g0, g1 in spec.mid_every:
            if j_from == g1:
                # fork request: rank sources by pre-land pending order so
                # the clones append in oracle order (see alloc_clones)
                rank = self._pending_rank(pred)
                old_m, old_r = self.spawn.get(g0, (None, None))
                if old_m is not None:       # a second land on the same g1
                    rank = rank + _count(old_m)[:, None]
                    pred_all = old_m | pred
                    rank = torch.where(pred, rank, old_r)
                    self.spawn[g0] = (pred_all, rank)
                else:
                    self.spawn[g0] = (pred, rank)
        if completed:
            self.m_mask = self.m_mask | pred
            self.m_ts = torch.where(pred, base_ts, self.m_ts)
            self.m_caps = torch.where(pred[:, :, None, None], self.caps,
                                      self.m_caps)
            # oracle emission order for same-event completions follows the
            # last unit's pending-list insertion order
            self.m_enter = torch.where(pred, self.enter, self.m_enter)
            self.m_seq = torch.where(pred, self.seq, self.m_seq)
            if spec.tail_every_start >= 0:
                # trailing `every`: the match is emitted AND the partial
                # re-arms at the group start, keeping its pre-group
                # captures (StreamPostStateProcessor.java:66-68)
                te = spec.tail_every_start
                self.st = torch.where(pred, te, self.st)
                rank = self._pending_rank(pred)
                self.seq = torch.where(pred, self.arm_seq[:, None] + rank,
                                       self.seq)
                self.arm_seq = self.arm_seq + _count(pred)
                self.enter = torch.where(pred, base_ts, self.enter)
                if self.lmask is not None:
                    self.lmask = torch.where(pred, 0, self.lmask)
                self.caps = self._clear_group_logical_rows(
                    self.caps, pred, te, len(spec.units) - 1)
            else:
                self.st = torch.where(pred, -1, self.st)
            return
        self.st = torch.where(pred, t, self.st)
        self.enter = torch.where(pred, base_ts, self.enter)
        if self.lmask is not None:
            self.lmask = torch.where(pred, 0, self.lmask)
        if self.cnt_prev is not None:
            if fwd_cnt is not None:
                dead = fwd_dead if fwd_dead is not None else \
                    torch.zeros_like(pred)
                self.cnt_prev = torch.where(
                    pred, torch.where(dead, -1, fwd_cnt), self.cnt_prev)
            elif live0:
                self.cnt_prev = torch.where(pred, 0, self.cnt_prev)
            else:
                self.cnt_prev = torch.where(pred, -1, self.cnt_prev)
            self.cnt_cur = torch.where(pred, 0, self.cnt_cur)
        if spec.units[t].kind == "absent":
            self.deadline = torch.where(
                pred, base_ts + spec.units[t].waiting_ms, self.deadline)

    def write_all(self, pred, row: int, ev_rows):
        """Write every lane of `row` for `pred` slots."""
        if row < 0:
            return
        R = self.caps.shape[2]
        sel = pred[:, :, None, None] & \
            (torch.arange(R, device=pred.device) == row)[None, None, :,
                                                          None]
        self.caps = torch.where(sel, ev_rows[:, row][:, None, None, :],
                                self.caps)

    def write_count(self, pred_first, pred_last, row: int, ev_rows, new_n):
        """Count-row append: first bank on the first append, last bank +
        __n lane on every append; e[last-j] banks shift behind the last
        bank (deepest first, BEFORE the new value lands) and e[k] banks
        capture the append that brings the chain to k+1 elements."""
        if row < 0:
            return
        spec = self.spec
        dev = self.caps.device
        R, C = self.caps.shape[2], self.caps.shape[3]
        lane = torch.arange(C, device=dev)
        nf = spec.n_first[row]
        first_lanes = lane < nf
        nl = spec.n_lane[row]
        n_l = spec.n_last[row] if spec.n_last else 0
        last_lanes = (lane >= nf) & (lane < nf + n_l)
        if nl >= 0:
            last_lanes = last_lanes & (lane != nl)
        row_sel = (torch.arange(R, device=dev) == row)[None, None, :, None]
        ev = ev_rows[:, row][:, None, None, :]
        mb = spec.lastk_banks[row] if spec.lastk_banks else ()
        src = spec.m_src[row] if spec.m_src else ()
        if mb and src:
            L = len(src)
            starts = {j: st for (j, st) in mb}
            caps = self.caps.clone()
            for j, start in sorted(mb, reverse=True):
                src_lanes = list(src if j == 1 else
                                 range(starts[j - 1], starts[j - 1] + L))
                dst_lanes = list(range(start, start + L))
                vals = caps[:, :, row, src_lanes]
                cur = caps[:, :, row, dst_lanes]
                caps[:, :, row, dst_lanes] = torch.where(
                    pred_last[:, :, None], vals, cur)
            self.caps = caps
        self.caps = torch.where(
            pred_first[:, :, None, None] & row_sel &
            first_lanes[None, None, None, :], ev, self.caps)
        self.caps = torch.where(
            pred_last[:, :, None, None] & row_sel &
            last_lanes[None, None, None, :], ev, self.caps)
        for (k, start, ln) in (spec.idx_banks[row]
                               if spec.idx_banks else ()):
            predk = pred_last & (new_n == k + 1)
            sel = (lane >= start) & (lane < start + ln)
            self.caps = torch.where(
                predk[:, :, None, None] & row_sel & sel[None, None, None, :],
                ev, self.caps)
        if nl >= 0:
            nsel = pred_last[:, :, None, None] & row_sel & \
                (lane == nl)[None, None, None, :]
            self.caps = torch.where(
                nsel, new_n.to(torch.float32)[:, :, None, None], self.caps)

    def clear_slot(self, pred):
        self.caps = torch.where(pred[:, :, None, None],
                                torch.zeros((), device=self.caps.device),
                                self.caps)

    def alloc_clones(self, g0: int, spawn, rank, ts):
        """Fork mid-chain `every` clones: for each source slot in `spawn`,
        place a new partial at unit g0 carrying the source's captures
        (group-side logical rows cleared) and chain-start timestamp.
        Sources ranked by pre-land pending order fill free slots in that
        order; unplaceable clones count as drops (the engine's
        grow-and-replay reruns the chunk on a bigger ring)."""
        spec = self.spec
        P, K = spawn.shape
        n_spawn = _count(spawn)
        free = (self.st < 0) & ~self.m_mask
        free_rank = _i32(torch.cumsum(_i32(free), dim=1)) - 1
        by_rank = torch.zeros((P, K + 1), dtype=torch.int32,
                              device=spawn.device)
        by_rank.scatter_(1, torch.where(spawn, rank, K).long(),
                         _i32(self.ar)[None, :].expand(P, K).contiguous())
        by_rank = by_rank[:, :K]
        src = by_rank.gather(1, free_rank.clamp(0, K - 1).long()).long()
        fill = free & (free_rank < n_spawn[:, None])
        self.st = torch.where(fill, g0, self.st)
        self.start = torch.where(fill, self.start.gather(1, src), self.start)
        lanes = torch.arange(P, device=spawn.device)[:, None]
        caps_src = self.caps[lanes, src]
        g1 = next(g1 for (s0, g1) in spec.mid_every if s0 == g0)
        caps_src = self._clear_group_logical_rows(caps_src, None, g0, g1)
        self.caps = torch.where(fill[:, :, None, None], caps_src, self.caps)
        self.enter = torch.where(fill, ts[:, None], self.enter)
        self.seq = torch.where(fill, self.arm_seq[:, None] + free_rank,
                               self.seq)
        self.arm_seq = self.arm_seq + n_spawn
        self.dropped = self.dropped + torch.clamp(n_spawn - _count(free),
                                                  min=0)
        if self.lmask is not None:
            self.lmask = torch.where(fill, 0, self.lmask)
        if self.cnt_cur is not None:
            self.cnt_cur = torch.where(fill, 0, self.cnt_cur)
            self.cnt_prev = torch.where(fill, -1, self.cnt_prev)


def _lookup(flags: List[bool], st: torch.Tensor, S: int) -> torch.Tensor:
    """flags[clip(st, 0, S)] per slot (flags has S + 1 entries)."""
    tab = torch.tensor(flags, dtype=torch.bool, device=st.device)
    return tab[st.clamp(0, S).long()]


def _one_event_step(spec: NfaSpec, carry: Dict, event, kprog=None):
    """Step every partition's slot ring over one event.

    event: cols dict of [P] tensors + __ts/__stream/__valid
    returns (new_carry, (match_mask [P, K], match_caps [P, K, R, C],
    match_ts [P, K], match_enter [P, K], match_seq [P, K]))"""
    units = spec.units
    S = len(units)
    K = spec.n_slots
    ts = event["__ts"]
    valid = event["__valid"]
    stream = event["__stream"]
    P = ts.shape[0]
    dev = ts.device
    tsc, validc, streamc = ts[:, None], valid[:, None], stream[:, None]

    s = _StepState(spec, carry, P, K, dev)
    ar = s.ar

    def only_first(pred_lane, free):
        """[P, K]: the first free slot of each lane where pred_lane."""
        return (pred_lane & free.any(dim=1))[:, None] & \
            (ar[None, :] == _first_true(free)[:, None])

    # telemetry leaf rides the carry untouched by the match math
    tel = carry.get("telem") if spec.telemetry else None
    tel_exp = torch.zeros((P,), dtype=torch.int32, device=dev)

    # ---- within expiry (reference isExpired :104-113 — start-state
    # partials are exempt)
    if spec.within_ms is not None:
        expired = (s.st >= 1) & (tsc - s.start > spec.within_ms)
        if spec.eps_start:
            expired = expired & ~((s.st == 1) & (s.cnt_prev == 0))
        if tel is not None:
            tel_exp = _count(expired)
        s.st = torch.where(expired, -1, s.st)

    # ---- leading absent ensure-arm: exactly one partial waits at unit 0
    # with a live deadline; arrivals below kill + re-arm it in place
    if spec.lead_absent:
        have0 = (s.st == 0).any(dim=1)
        want0 = valid & (stream != -2) & ~have0
        free0 = (s.st < 0) & ~s.m_mask
        armed0 = only_first(want0, free0)
        s.clear_slot(armed0)
        s.st = torch.where(armed0, 0, s.st)
        s.deadline = torch.where(armed0, tsc + spec.units[0].waiting_ms,
                                 s.deadline)
        s.start = torch.where(armed0, tsc, s.start)
        s.enter = torch.where(armed0, tsc, s.enter)
        s.seq = torch.where(armed0, s.arm_seq[:, None], s.seq)
        s.arm_seq = s.arm_seq + _i32(armed0.any(dim=1))
        if s.lmask is not None:
            s.lmask = torch.where(armed0, 0, s.lmask)
        if s.cnt_cur is not None:
            s.cnt_cur = torch.where(armed0, 0, s.cnt_cur)
            s.cnt_prev = torch.where(armed0, -1, s.cnt_prev)
        s.dropped = s.dropped + _i32(want0 & ~free0.any(dim=1))

    # ---- SEQUENCE early deadline pass: a due `not … for t` confirms
    # before the arriving event stabilizes the sequence
    if spec.is_sequence and _has(spec, "absent"):
        for j, u in enumerate(spec.units):
            if u.kind != "absent":
                continue
            fire = validc & (s.st == j) & (s.deadline <= tsc)
            s.land(fire, j, s.deadline)

    # ---- SEQUENCE stabilize barrier for absent units: any real event
    # (timer rows, stream -2, excepted) kills a partial waiting at `not`
    if spec.is_sequence and _has(spec, "absent"):
        at_absent = _lookup([u.kind == "absent" for u in spec.units] +
                            [False], s.st, S)
        kill0 = validc & (streamc != -2) & (s.st >= 0) & at_absent
        s.st = torch.where(kill0, -1, s.st)

    # ---- leading min-0 kleene: ensure exactly one virgin start chain
    # (cnt_prev == 0) at unit 1
    if spec.eps_start:
        if spec.is_sequence:
            have = ((s.st == 1) & (s.cnt_prev >= 0)).any(dim=1)
        else:
            have = (s.st == 1).any(dim=1)
        want = valid & ~have
        if spec.arm_once:
            want = want & (s.armed_total == 0)
        freev = (s.st < 0) & ~s.m_mask
        armed_v = only_first(want, freev)
        s.clear_slot(armed_v)
        s.st = torch.where(armed_v, 1, s.st)
        s.cnt_cur = torch.where(armed_v, 0, s.cnt_cur)
        s.cnt_prev = torch.where(armed_v, 0, s.cnt_prev)
        s.start = torch.where(armed_v, tsc, s.start)
        s.enter = torch.where(armed_v, tsc, s.enter)
        s.seq = torch.where(armed_v, s.arm_seq[:, None], s.seq)
        s.arm_seq = s.arm_seq + _i32(armed_v.any(dim=1))
        if s.lmask is not None:
            s.lmask = torch.where(armed_v, 0, s.lmask)
        if spec.arm_once:
            s.armed_total = s.armed_total + _i32(want & freev.any(dim=1))
        s.dropped = s.dropped + _i32(want & ~freev.any(dim=1))

    st_pre = s.st
    # pre-event live-append state (see the JAX package's note)
    cnt_prev_pre = s.cnt_prev

    # ---- condition programs over the current capture state
    conds = _eval_conds(spec, event, s.caps, kprog)
    ev_rows = _event_rows(spec, event)

    advanced = torch.zeros((P, K), dtype=torch.bool, device=dev)
    appended = torch.zeros((P, K), dtype=torch.bool, device=dev)
    seed_req = None
    seq_block_arm = torch.zeros((P,), dtype=torch.bool, device=dev)

    # ---- main transitions, one unit at a time (statically unrolled)
    for j, u in enumerate(units):
        at = validc & (st_pre == j)
        if u.kind == "simple":
            ok = at & (streamc == u.stream_a) & conds[u.cond_a]
            if spec.eps_start and j == 1:
                if spec.is_sequence and s.seq_froze is not None:
                    ok = ok & ~((s.cnt_prev == 0) &
                                (s.seq_froze[:, None] > 0))
                if spec.is_sequence and spec.is_every:
                    seed_req = (ok & (s.cnt_prev == 0)).any(dim=1)
                s.start = torch.where(ok & (s.cnt_prev == 0), tsc, s.start)
            s.write_all(ok, u.row_a, ev_rows)
            s.land(ok, j, tsc)
            advanced = advanced | ok
        elif u.kind == "logical":
            bitA = (s.lmask & 1) > 0
            bitB = (s.lmask & 2) > 0
            newA = at & (streamc == u.stream_a) & conds[u.cond_a] & ~bitA
            newB = at & (streamc == u.stream_b) & conds[u.cond_b] & ~bitB
            if not u.is_and:
                newB = newB & ~newA
            s.write_all(newA, u.row_a, ev_rows)
            s.write_all(newB, u.row_b, ev_rows)
            haveA, haveB = bitA | newA, bitB | newB
            done = at & ((haveA & haveB) if u.is_and else (newA | newB))
            s.lmask = torch.where(newA, s.lmask | 1, s.lmask)
            s.lmask = torch.where(newB, s.lmask | 2, s.lmask)
            s.land(done, j, tsc)
            advanced = advanced | done
            appended = appended | ((newA | newB) & ~done)
        elif u.kind == "count":
            ok = at & (streamc == u.stream_a) & conds[u.cond_a]
            c2 = s.cnt_cur + 1
            s.write_count(ok & (s.cnt_cur == 0), ok, u.row_a, ev_rows, c2)
            s.cnt_cur = torch.where(ok, c2, s.cnt_cur)
            reach = ok & (c2 == u.min_count)
            dead = reach & (c2 == u.max_count)
            s.land(reach, j, tsc, fwd_cnt=c2, fwd_dead=dead)
            advanced = advanced | reach
            if spec.is_sequence and j == 1 and \
                    units[0].kind == "simple":
                seq_block_arm = seq_block_arm | \
                    (ok & (c2 >= u.min_count) &
                     (c2 != u.max_count)).any(dim=1)
            if spec.is_sequence:
                appended = appended | (ok & (c2 >= u.min_count))
            else:
                appended = appended | ok
        elif u.kind == "absent":
            kill = at & (streamc == u.stream_a) & conds[u.cond_a]
            if j == 0 and spec.lead_absent:
                s.deadline = torch.where(kill, tsc + u.waiting_ms,
                                         s.deadline)
                s.start = torch.where(kill, tsc, s.start)
                s.enter = torch.where(kill, tsc, s.enter)
            else:
                s.st = torch.where(kill, -1, s.st)

    # ---- live-append phase: a forwarded count keeps growing its last
    # bank while the next unit is pending
    if s.cnt_prev is not None:
        for j, u in enumerate(units):
            if u.kind != "count":
                continue
            t, _live0, completed = _land_static(spec, j)
            if completed:
                continue        # trailing count: match already emitted
            live = validc & (st_pre == t) & (s.cnt_prev >= 0) & ~advanced
            ok = live & (streamc == u.stream_a) & conds[u.cond_a] & \
                (s.cnt_prev < u.max_count)
            if spec.eps_start and j == 0:
                s.start = torch.where(ok & (s.cnt_prev == 0), tsc, s.start)
            c2 = s.cnt_prev + 1
            s.write_count(ok & (s.cnt_prev == 0), ok, u.row_a, ev_rows, c2)
            s.cnt_prev = torch.where(ok, c2, s.cnt_prev)
            froze = ok & (c2 == u.max_count)
            s.cnt_prev = torch.where(froze, -1, s.cnt_prev)
            appended = appended | ok
            if j == 0 and spec.eps_start and spec.is_sequence and \
                    s.seq_froze is not None:
                s.seq_froze = torch.where(valid, _i32(froze.any(dim=1)),
                                          s.seq_froze)
            if spec.is_sequence and j == 1 and \
                    units[0].kind == "simple":
                seq_block_arm = seq_block_arm | (ok & ~froze).any(dim=1)

    # ---- SEQUENCE strict contiguity
    if spec.is_sequence:
        is_real = valid & (stream != -2)
        at_strict = _lookup([u.kind in ("simple", "count", "logical")
                             for u in units] + [False], st_pre, S)
        at_logical = _lookup([u.kind == "logical" for u in units] +
                             [False], st_pre, S)
        half_done = at_logical & (s.lmask != 0) \
            if s.lmask is not None else torch.zeros_like(at_logical)
        kill = is_real[:, None] & (st_pre >= 0) & (s.st >= 0) & \
            at_strict & ~(advanced | appended) & ~half_done
        s.st = torch.where(kill, -1, s.st)

    # ---- arming a fresh partial at unit 0
    u0 = units[0]
    if (spec.is_every and spec.every_group_end > 0) or \
            u0.kind in ("count", "logical"):
        occ_gate = ~((st_pre >= 0) &
                     (st_pre <= spec.every_group_end)).any(dim=1)
    else:
        occ_gate = torch.ones((P,), dtype=torch.bool, device=dev)
    if spec.is_sequence and u0.kind == "count" and not spec.eps_start \
            and not spec.dead_start:
        t0, _l0, _c0 = _land_static(spec, 0)
        occ = (st_pre >= 0) & (st_pre <= spec.every_group_end)
        if not _c0:
            occ = occ | ((st_pre == t0) & (cnt_prev_pre >= 0))
        occ_gate = ~occ.any(dim=1)
    if spec.arm_once:
        occ_gate = occ_gate & (s.armed_total == 0)

    def lane_full(v):
        return torch.full((P,), v, dtype=torch.int32, device=dev)

    arm = torch.zeros((P,), dtype=torch.bool, device=dev)
    arm_state = lane_full(0)
    arm_lmask = lane_full(0)
    arm_cnt_cur = lane_full(0)
    arm_cnt_prev = lane_full(-1)
    arm_match = torch.zeros((P,), dtype=torch.bool, device=dev)
    arm_row_writes: List[int] = []      # rows the arming event captures
    arm_n1_rows: List[int] = []         # count rows written with __n = 1

    if u0.kind == "simple":
        c0 = valid & (stream == u0.stream_a) & conds[u0.cond_a][:, 0]
        t, _live0, completed = _land_static(spec, 0)
        arm = c0
        arm_row_writes.append(u0.row_a)
        if completed:
            arm_match = c0
        else:
            arm_state = lane_full(t)
            arm_cnt_prev = lane_full(0 if _live0 else -1)
    elif u0.kind == "count" and spec.eps_start:
        pass        # leading min-0: arming is the ensure-virgin block above
    elif u0.kind == "count" and spec.dead_start:
        pass        # SEQUENCE min>=2: dead shape, never arms (see NfaSpec)
    elif u0.kind == "count":
        if spec.is_sequence:
            # a SEQUENCE re-arm is a FRESH empty chain: virgin context
            cond0 = _cond_on(spec, event, u0.cond_a,
                             _zero_caps(spec, P, dev), kprog)
        else:
            cond0 = conds[u0.cond_a][:, 0]
        c0 = valid & (stream == u0.stream_a) & cond0
        arm = c0
        arm_row_writes.append(u0.row_a)
        arm_n1_rows.append(u0.row_a)
        if u0.min_count <= 1:
            t, _live0, completed = _land_static(spec, 0)
            if completed:
                arm_match = c0
            else:
                arm_state = lane_full(t)
                arm_cnt_prev = lane_full(-1 if u0.max_count == 1 else 1)
        else:
            arm_state = lane_full(0)
            arm_cnt_cur = lane_full(1)
    elif u0.kind == "logical":
        cA = valid & (stream == u0.stream_a) & conds[u0.cond_a][:, 0]
        cB = valid & (stream == u0.stream_b) & conds[u0.cond_b][:, 0]
        if not u0.is_and:
            cB = cB & ~cA       # or: same-event double match, left wins
        arm = cA | cB
        both = (cA & cB) if u0.is_and else (cA | cB)
        t, _live0, completed = _land_static(spec, 0)
        arm_match = both if completed else \
            torch.zeros((P,), dtype=torch.bool, device=dev)
        arm_state = torch.where(both, -2 if completed else t, lane_full(0))
        # a completed leading unit advances with a CLEAN mask
        arm_lmask = torch.where(both, 0, _i32(torch.where(cA, 1, 0) |
                                              torch.where(cB, 2, 0)))
        arm_cnt_prev = lane_full(0 if _live0 else -1)
        arm_row_writes = []     # handled below with per-side predicates

    do_arm = arm & occ_gate & ~seq_block_arm
    free = (s.st < 0) & ~s.m_mask
    any_free = free.any(dim=1)
    armed_here = only_first(do_arm, free)
    s.dropped = s.dropped + _i32(do_arm & ~any_free)
    if spec.arm_once:
        s.armed_total = s.armed_total + _i32(do_arm & any_free)
        if spec.is_sequence:
            # a non-every sequence is single-shot: its one initial partial
            # dies forever on the first real event it cannot advance on
            virgin_dies = valid & (stream != -2) & (s.armed_total == 0)
            s.armed_total = torch.where(virgin_dies, 2, s.armed_total)

    s.clear_slot(armed_here)
    if u0.kind == "logical":
        cA = valid & (stream == u0.stream_a) & conds[u0.cond_a][:, 0]
        cB = valid & (stream == u0.stream_b) & conds[u0.cond_b][:, 0]
        if not u0.is_and:
            cB = cB & ~cA
        s.write_all(armed_here & cA[:, None], u0.row_a, ev_rows)
        s.write_all(armed_here & cB[:, None], u0.row_b, ev_rows)
    else:
        for r in arm_row_writes:
            if r in arm_n1_rows:
                s.write_count(armed_here, armed_here, r, ev_rows,
                              torch.ones((P, K), dtype=torch.int32,
                                         device=dev))
            else:
                s.write_all(armed_here, r, ev_rows)
    emit_arm = armed_here & arm_match[:, None]
    s.m_mask = s.m_mask | emit_arm
    s.m_ts = torch.where(emit_arm, tsc, s.m_ts)
    s.m_caps = torch.where(emit_arm[:, :, None, None], s.caps, s.m_caps)
    s.m_enter = torch.where(emit_arm, tsc, s.m_enter)
    s.m_seq = torch.where(emit_arm, s.arm_seq[:, None], s.m_seq)
    live_arm = armed_here & ~arm_match[:, None]
    s.st = torch.where(live_arm, arm_state[:, None], s.st)
    s.start = torch.where(live_arm | emit_arm, tsc, s.start)
    s.enter = torch.where(live_arm, tsc, s.enter)
    s.seq = torch.where(live_arm, s.arm_seq[:, None], s.seq)
    s.arm_seq = s.arm_seq + _i32(armed_here.any(dim=1))
    if s.lmask is not None:
        s.lmask = torch.where(live_arm, arm_lmask[:, None], s.lmask)
    if s.cnt_cur is not None:
        s.cnt_cur = torch.where(live_arm, arm_cnt_cur[:, None], s.cnt_cur)
        s.cnt_prev = torch.where(live_arm, arm_cnt_prev[:, None],
                                 s.cnt_prev)
    if s.deadline is not None and len(units) > 1:
        t0, _l0, _c0 = _land_static(spec, 0)
        if t0 < S and units[t0].kind == "absent":
            s.deadline = torch.where(live_arm & (s.st == t0),
                                     tsc + units[t0].waiting_ms, s.deadline)

    # ---- every-min-0 SEQUENCE seed: the NEXT chain starts with THIS
    # event when the virgin closed and the event passes the kleene
    if seed_req is not None:
        c0 = valid & (stream == u0.stream_a) & \
            _cond_on(spec, event, u0.cond_a, _zero_caps(spec, P, dev), kprog)
        want_seed = seed_req & c0
        free_s = (s.st < 0) & ~s.m_mask
        seeded = only_first(want_seed, free_s)
        s.clear_slot(seeded)
        s.st = torch.where(seeded, 1, s.st)
        s.write_count(seeded, seeded, u0.row_a, ev_rows,
                      torch.ones((P, K), dtype=torch.int32, device=dev))
        mx1 = u0.max_count == 1
        s.cnt_prev = torch.where(seeded, -1 if mx1 else 1, s.cnt_prev)
        s.cnt_cur = torch.where(seeded, 0, s.cnt_cur)
        s.start = torch.where(seeded, tsc, s.start)
        s.enter = torch.where(seeded, tsc, s.enter)
        s.seq = torch.where(seeded, s.arm_seq[:, None], s.seq)
        s.arm_seq = s.arm_seq + _i32(seeded.any(dim=1))
        s.dropped = s.dropped + _i32(want_seed & ~free_s.any(dim=1))
        if mx1 and s.seq_froze is not None:
            s.seq_froze = torch.where(seeded.any(dim=1), 1, s.seq_froze)

    # ---- mid-chain `every` clone allocation (after arming: armed
    # partial first, clones after, as the oracle appends them)
    for g0 in sorted(s.spawn):
        spm, rk = s.spawn[g0]
        s.alloc_clones(g0, spm, rk, ts)

    # ---- absent deadline pass: every due `not … for t` fires AFTER the
    # event was processed; ascending unit order cascades in one pass
    if s.deadline is not None:
        for j, u in enumerate(units):
            if u.kind != "absent":
                continue
            fire = validc & (s.st == j) & (s.deadline <= tsc)
            s.land(fire, j, s.deadline)

    out = {"slot_state": s.st, "slot_start": s.start,
           "slot_enter": s.enter, "slot_seq": s.seq, "arm_seq": s.arm_seq,
           "captures": s.caps, "dropped": s.dropped}
    if s.cnt_cur is not None:
        out["cnt_cur"] = s.cnt_cur
        out["cnt_prev"] = s.cnt_prev
    if s.seq_froze is not None:
        out["seq_froze"] = s.seq_froze
    if s.lmask is not None:
        out["lmask"] = s.lmask
    if s.deadline is not None:
        out["deadline"] = s.deadline
    if s.armed_total is not None:
        out["armed_total"] = s.armed_total
    if tel is not None:
        tel_pass, tel_fail = [], []
        for j, u in enumerate(units):
            at = validc & (st_pre == j)
            if u.cond_a >= 0:
                elig = at & (streamc == u.stream_a)
                hit = elig & conds[u.cond_a]
            else:
                elig = torch.zeros((P, K), dtype=torch.bool, device=dev)
                hit = elig
            if u.cond_b >= 0:
                elig_b = at & (streamc == u.stream_b)
                hit = hit | (elig_b & conds[u.cond_b])
                elig = elig | elig_b
            tel_pass.append(_count(hit))
            tel_fail.append(_count(elig & ~hit))
        occ = _count(s.st[:, None, :] ==
                     torch.arange(S, device=dev)[None, :, None])
        out["telem"] = torch.cat([
            occ,                                    # live occupancy gauge
            tel[:, S:2 * S] + torch.stack(tel_pass, dim=1),
            tel[:, 2 * S:3 * S] + torch.stack(tel_fail, dim=1),
            (tel[:, 3 * S] + tel_exp)[:, None],     # within-expiry drops
        ], dim=1)
    return out, (s.m_mask, s.m_caps, s.m_ts, s.m_enter, s.m_seq)


def nfa_block_step_plain(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                         block: Dict[str, torch.Tensor],
                         batch_b: Optional[int] = None,
                         kprog: Optional[NfaKernelProgram] = None):
    """The block step in plain PyTorch: ``(carry, block of [P, T]
    tensors) → (new carry, (mask [P, T, K], caps [P, T, K, R, C],
    ts [P, T, K], enter [P, T, K], seq [P, T, K]))`` — the JAX package's
    ``build_block_step`` with ``vmap`` written out and ``lax.scan`` as a
    loop over T.  Functional: the input carry is not modified.

    With B > 1 (``batch_b``, default the spec's) capture-free conditions
    are hoisted block-wide first, as in the JAX package.  With ``kprog``
    every condition is computed from the kernel's inputs instead (its
    gate word and compare table): the CPU model of csrc/nfa_step.cu."""
    B = resolve_batch_b(spec.batch_b or None) if batch_b is None \
        else resolve_batch_b(batch_b)
    events = dict(block)
    T = int(events["__ts"].shape[1])
    if kprog is not None:
        events[KGATE] = kernel_gate_word(spec, kprog, events)
    elif B > 1:
        events.update(_hoist_cond_gates(spec, events))
        events, T, _ticks = _pad_block_t(events, B)
    steps = int(events["__ts"].shape[1])
    P, K = events["__ts"].shape[0], spec.n_slots
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    dev = events["__ts"].device
    ys: List[tuple] = []
    c = carry
    for t in range(steps):
        c, y = _one_event_step(spec, c, {k: v[:, t]
                                         for k, v in events.items()}, kprog)
        ys.append(y)
    if not ys:
        i32 = dict(dtype=torch.int32, device=dev)
        return dict(carry), (
            torch.zeros((P, 0, K), dtype=torch.bool, device=dev),
            torch.zeros((P, 0, K, R, C), dtype=torch.float32, device=dev),
            torch.zeros((P, 0, K), **i32), torch.zeros((P, 0, K), **i32),
            torch.zeros((P, 0, K), **i32))
    outs = tuple(torch.stack([y[i] for y in ys], dim=1)[:, :T]
                 for i in range(5))
    return c, outs


def make_timer_block(n_partitions: int, ts_offset: int,
                     attr_names) -> Dict[str, np.ndarray]:
    """One virtual TIMER row per partition lane (stream code -2 matches no
    unit): drives absent-state deadlines and within expiry between real
    events (≙ the reference Scheduler's TIMER StreamEvents,
    util/Scheduler.java:180-211)."""
    block = {a: np.zeros((n_partitions, 1), np.float32) for a in attr_names}
    block["__ts"] = np.full((n_partitions, 1), ts_offset, np.int32)
    block["__stream"] = np.full((n_partitions, 1), -2, np.int32)
    block["__valid"] = np.ones((n_partitions, 1), bool)
    return block


# ------------------------------------------------------------ the egress

def egress_pack_plain(spec: NfaSpec, mask, caps, ts, enter, seq, dropped,
                      dl_st=None, dl=None, cap: int = 1024) -> torch.Tensor:
    """The match compaction of one block's dense outputs (the JAX
    package's ``plan/nfa_compiler.py`` ``_egress_pack_fn``): ONE
    [cap+1, 4+R*C] int32 slab of the MATCHED slots in ascending flat
    index (index, ts, enter, seq, float32 capture row viewed as int32;
    rows past the count hold -1 in column 0), plus a tail row (true
    count, summed dropped, earliest live absent deadline)."""
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    S = len(spec.units)
    dev = mask.device
    flat = mask.reshape(-1)
    idx = torch.nonzero_static(flat, size=cap, fill_value=-1)[:, 0]
    safe = idx.clamp(min=0)

    def g(a):
        return a.reshape(-1)[safe][:, None]
    caps_i = caps.contiguous().view(torch.int32).reshape(-1, R * C)[safe]
    rows = torch.cat([idx.to(torch.int32)[:, None], g(ts), g(enter),
                      g(seq), caps_i], dim=1)
    tail = torch.zeros((1, 4 + R * C), dtype=torch.int32, device=dev)
    tail[0, 0] = flat.sum()
    tail[0, 1] = dropped.sum()
    if dl is not None:
        # earliest live absent-state deadline rides the egress tail: the
        # pipelined engine schedules its host TIMER off the retired
        # chunk's carry with no extra device read
        absent = torch.tensor([u.kind == "absent" for u in spec.units] +
                              [False], dtype=torch.bool, device=dev)
        waiting = absent[dl_st.clamp(0, S).long()] & (dl_st >= 0)
        tail[0, 2] = torch.where(waiting, dl, 2 ** 31 - 1).min()
    return torch.cat([rows, tail], dim=0)


class NfaEgress(NamedTuple):
    """One block's egress on the device.

    ``buf`` is [cap + 2, 4 + R*C] int32: the slab (:func:`egress_pack_plain`'s
    cap + 1 rows, tail last) and then one status row, ``[fullest scratch
    segment's rows, seg, 0, ...]`` (all zero on the plain path, which has
    no segments).  The step lost rows to a full segment iff status[0] >
    status[1]; the count may exceed cap.  ``repack(cap)`` re-runs the
    compaction alone at another cap and returns a new buf.  ``seg`` is
    the scratch rows per CTA the step ran with (0: plain)."""
    buf: torch.Tensor
    repack: Callable[[int], torch.Tensor]
    seg: int


def _status_row(max_fill: int, seg: int, width: int, dev) -> torch.Tensor:
    row = torch.zeros((1, width), dtype=torch.int32, device=dev)
    row[0, 0] = max_fill
    row[0, 1] = seg
    return row


# ------------------------------------------------------------ the kernels

#: carry leaves the kernel reads and writes, in its argument order
KERNEL_CARRY = ("slot_state", "slot_start", "slot_enter", "slot_seq",
                "arm_seq", "captures", "dropped", "armed_total")

#: threads per CTA of csrc/nfa_step.cu's step kernel
KERNEL_THREADS = 256

#: bit 31 of the kernel's gate word carries the event's __valid
_VALID_BIT = -(2 ** 31)

_PROG_CACHE: Dict[tuple, torch.Tensor] = {}


def kernel_geometry(n_slots: int) -> Tuple[int, int]:
    """(G, L) of csrc/nfa_step.cu for a ring of K = ``n_slots``: G
    threads per lane (K rounded up to a power of two, at most 32; thread
    ``g`` owns slots g, g + G, ...) and L = 256 / G lanes per CTA."""
    G = min(32, 1 << max(int(n_slots) - 1, 0).bit_length())
    return G, KERNEL_THREADS // G


def default_segment(lanes_per_cta: int) -> int:
    """Scratch rows per CTA to start with: four matches per lane."""
    return 4 * lanes_per_cta


def kernel_prog(spec: NfaSpec, kprog: NfaKernelProgram) -> List[int]:
    """The kernel's static program table (int32), in the layout
    csrc/nfa_step.cu reads:

      S, R, C, has_within, within_ms, arm_once, n_cond, n_cmp, n_pcmp,
      S × (stream, cond, row), R·C × row_src,
      (n_cond + 1) × cmp_start, n_cmp × (attr, row, lane, op),
      (n_cond + 1) × pcmp_start, n_pcmp × (attr, param, op)"""
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)

    def table(per_cond):
        start, flat = [0], []
        for entries in per_cond:
            for e in entries:
                flat.extend(e)
            start.append(start[-1] + len(entries))
        return start, flat
    cmp_start, cmp = table(kprog.cmp)
    pcmp_start, pcmp = table(kprog.pcmp or [()] * len(kprog.cmp))
    prog = [len(spec.units), R, C, int(spec.within_ms is not None),
            int(spec.within_ms or 0), int(spec.arm_once),
            len(kprog.cmp), cmp_start[-1], pcmp_start[-1]]
    for u in spec.units:
        prog += [u.stream_a, u.cond_a, u.row_a]
    prog += list(kprog.row_src) + cmp_start + cmp + pcmp_start + pcmp
    return prog


def _prog_tensor(spec: NfaSpec, kprog: NfaKernelProgram, dev) -> torch.Tensor:
    key = (tuple(kernel_prog(spec, kprog)), str(dev))
    t = _PROG_CACHE.get(key)
    if t is None:
        t = _PROG_CACHE[key] = torch.tensor(list(key[0]), dtype=torch.int32,
                                            device=dev)
    return t


def _check(name: str, t: torch.Tensor, dtype, shape, device,
           who: str = "nfa_step_egress") -> None:
    if t.device != device:
        raise ValueError(f"{who}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def nfa_compact(rows: torch.Tensor, lane_count: torch.Tensor,
                fill: torch.Tensor, dropped: torch.Tensor, P: int, L: int,
                seg: int, cap: int, width: int) -> torch.Tensor:
    """Launch csrc/nfa_step.cu's compaction: one step's scratch rows
    (``fill`` per CTA, ``lane_count`` per lane) into a new [cap + 2,
    width] egress buffer (slab, tail, status).  CUDA tensors only."""
    dev = fill.device
    buf = torch.empty((cap + 2, width), dtype=torch.int32, device=dev)
    lib = load_kernel("nfa_step")
    rc = lib.nfa_compact(rows.data_ptr(), lane_count.data_ptr(),
                         fill.data_ptr(), dropped.data_ptr(), buf.data_ptr(),
                         P, L, seg, fill.numel(), cap, width,
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nfa_compact: launch failed with CUDA error {rc}")
    nfa_compact.launches += 1
    return buf


#: launches of the compaction kernel since the last reset
nfa_compact.launches = 0


def nfa_step_egress(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                    block: Dict[str, torch.Tensor],
                    kprog: Optional[NfaKernelProgram] = None,
                    cap: int = 1024, seg: Optional[int] = None,
                    batch_b: Optional[int] = None):
    """One block step and its match compaction on the tensors' own
    device: ``(carry, [P, T] block) → (new carry, NfaEgress)``.

    CPU tensors run the plain composition (every spec):
    :func:`nfa_block_step_plain`, then :func:`egress_pack_plain`.  CUDA
    tensors launch csrc/nfa_step.cu on the current stream, the step
    (``seg`` scratch rows per CTA, default :func:`default_segment`) and
    then the compaction, for a spec inside its class (``kprog.reason is
    None``); the dense [P, T, K, ...] outputs are never written.
    Anything else, and a failed build, load or launch, raises — there is
    no fallback to the plain version.  The input carry survives
    (grow-and-replay re-runs a chunk from it)."""
    dev = block["__ts"].device
    K = spec.n_slots
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    width = 4 + R * C
    if dev.type == "cpu":
        new, outs = nfa_block_step_plain(spec, carry, block, batch_b)
        absent = _has(spec, "absent")
        dl_st = new["slot_state"] if absent else None
        dl = new.get("deadline") if absent else None

        def repack_plain(c: int) -> torch.Tensor:
            return torch.cat([
                egress_pack_plain(spec, *outs, new["dropped"], dl_st, dl, c),
                _status_row(0, 0, width, dev)])
        return new, NfaEgress(repack_plain(cap), repack_plain, 0)
    if kprog is None or kprog.reason is not None:
        raise RuntimeError(
            "nfa_step_egress: spec outside the CUDA kernel's class ("
            f"{'no kernel program' if kprog is None else kprog.reason})")
    if any(kprog.pcmp):
        raise RuntimeError("nfa_step_egress: a parameterized spec steps "
                           "through the pattern bank (nfa_bank_step)")
    if dev.type != "cuda":
        raise RuntimeError(f"nfa_step_egress: no kernel for device {dev}")
    P, T = block["__ts"].shape
    G, L = kernel_geometry(K)
    n_cta = -(-P // L)
    seg = default_segment(L) if seg is None else int(seg)
    _check("__ts", block["__ts"], torch.int32, (P, T), dev)
    _check("__stream", block["__stream"], torch.int32, (P, T), dev)
    _check("__valid", block["__valid"], torch.bool, (P, T), dev)
    for name in KERNEL_CARRY:
        if name == "armed_total" and not spec.arm_once:
            continue
        shape = {"arm_seq": (P,), "dropped": (P,), "armed_total": (P,),
                 "captures": (P, K, R, C)}.get(name, (P, K))
        _check(name, carry[name], carry_dtype(name), shape, dev)
    A = len(kprog.kern_attrs)
    if A == 1:
        attrs = block[kprog.kern_attrs[0]]
        _check("attrs", attrs, torch.float32, (P, T), dev)
    elif A:
        attrs = torch.stack([block[a] for a in kprog.kern_attrs])
        _check("attrs", attrs, torch.float32, (A, P, T), dev)
    else:
        attrs = torch.zeros((1,), dtype=torch.float32, device=dev)
    gates = kernel_gate_word(spec, kprog, block)
    gates = torch.where(block["__valid"], gates | _VALID_BIT, gates)
    prog = _prog_tensor(spec, kprog, dev)
    new = {k: torch.empty_like(carry[k]) for k in KERNEL_CARRY
           if k in carry}
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.empty((max(n_cta * seg * (width + 2), 1),), **i32)
    lane_count = torch.empty((P,), **i32)
    fill = torch.empty((n_cta,), **i32)
    lib = load_kernel("nfa_step")
    armed_in = carry.get("armed_total")
    armed_out = new.get("armed_total")
    rc = lib.nfa_step(
        attrs.data_ptr(), block["__ts"].data_ptr(),
        block["__stream"].data_ptr(), gates.data_ptr(), prog.data_ptr(),
        prog.numel(),
        *[carry[k].data_ptr() for k in KERNEL_CARRY[:7]],
        armed_in.data_ptr() if armed_in is not None else None,
        *[new[k].data_ptr() for k in KERNEL_CARRY[:7]],
        armed_out.data_ptr() if armed_out is not None else None,
        rows.data_ptr(), lane_count.data_ptr(), fill.data_ptr(),
        P, T, K, G, seg, A, R * C,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nfa_step: launch failed with CUDA error {rc}")
    nfa_step_egress.launches += 1
    dropped = new["dropped"]

    def repack(c: int) -> torch.Tensor:
        return nfa_compact(rows, lane_count, fill, dropped, P, L, seg, c,
                           width)
    return new, NfaEgress(repack(cap), repack, seg)


#: launches of the step kernel since the last reset (plain runs excluded)
nfa_step_egress.launches = 0


# ------------------------------------------------------------ the pattern bank

def make_bank_carry(spec: NfaSpec, n_patterns: int, n_partitions: int,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """An empty bank carry: :func:`make_carry`'s leaves with a leading
    pattern axis, [n_patterns, P, ...], materialised (the CUDA bank step
    may update it in place)."""
    c = make_carry(spec, n_partitions, device)
    return {k: v[None].expand((n_patterns,) + tuple(v.shape)).contiguous()
            for k, v in c.items()}


def _bank_lead(carry: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
    """The carry's pattern axes: (N,) or (C, N)."""
    return tuple(carry["slot_state"].shape[:-2])


#: lanes × events the plain bank step holds at once; a larger bank is
#: stepped in slices of patterns (patterns never interact)
PLAIN_BANK_BUDGET = 1 << 25


def _bank_slice_plain(spec: NfaSpec, carry, block, prm, n: int, B: int,
                      kprog: Optional[NfaKernelProgram]):
    """n patterns' lanes ([n * P] carry rows) over the shared [P, T] block,
    each pattern's constants as per-lane event columns."""
    P = int(block["__ts"].shape[0])
    T = int(block["__ts"].shape[1])

    def tile(v):
        return v.unsqueeze(0).expand((n,) + tuple(v.shape)).reshape(
            (n * P,) + tuple(v.shape[1:]))
    events = {k: tile(v) for k, v in block.items()}
    for name, v in prm.items():
        events[name] = v[:, None, None].expand(n, P, T).reshape(n * P, T)
    if kprog is not None:
        events[KGATE] = tile(kernel_gate_word(spec, kprog, block))
    elif B > 1:
        events.update(_hoist_cond_gates(spec, events))
        events, _T, _ticks = _pad_block_t(events, B)
    dev = block["__ts"].device
    i32 = dict(dtype=torch.int32, device=dev)
    cnt = torch.zeros((n * P,), **i32)
    lmt = torch.zeros((n * P,), **i32)
    lmk = torch.zeros((n * P,), **i32)
    c = carry
    for t in range(int(events["__ts"].shape[1])):
        ev = {k: v[:, t] for k, v in events.items()}
        c, (mm, *_rest) = _one_event_step(spec, c, ev, kprog)
        hit = mm.any(dim=1)
        cnt = cnt + _count(mm)
        # the EVENT's ts, and the lowest matched slot (jnp.argmax)
        lmt = torch.where(hit, ev["__ts"], lmt)
        lmk = torch.where(hit, _i32(_first_true(mm)), lmk)
    return dict(c), cnt, lmt, lmk


def bank_lanes_plain(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                     block: Dict[str, torch.Tensor],
                     params: Dict[str, torch.Tensor],
                     batch_b: Optional[int] = None,
                     kprog: Optional[NfaKernelProgram] = None):
    """The bank step per lane in plain PyTorch: ``(carry [*lead, P, ...],
    one [P, T] block shared by every pattern, {param: [*lead] float32})
    → (new carry, count, lmt, lmk)``, the last three [CN, P] int32 with CN
    the product of the pattern axes ``lead``: per pattern lane the
    block's matches, and at the lane's last event with a match that
    event's ``__ts`` and its lowest matched slot (0 and 0 where none).
    The JAX package's ``build_bank_step`` ``per_partition`` with the
    pattern axes flattened into the lane axis of the plain step.

    B > 1 hoists capture-free conditions (the pattern constants ride the
    events as lane columns); ``kprog`` computes every condition from the
    kernel's inputs instead (the CPU model of csrc/nfa_step.cu's bank
    step).  Functional: the input carry is not modified."""
    B = resolve_batch_b(spec.batch_b or None) if batch_b is None \
        else resolve_batch_b(batch_b)
    lead = _bank_lead(carry)
    CN = int(np.prod(lead)) if lead else 1
    P, T = (int(x) for x in block["__ts"].shape)
    flat = {k: v.reshape((CN * P,) + tuple(v.shape[len(lead) + 1:]))
            for k, v in carry.items()}
    prm = {k: v.reshape(CN).to(torch.float32) for k, v in params.items()}
    step = max(1, PLAIN_BANK_BUDGET // max(P * max(T, 1), 1))
    parts = []
    for n0 in range(0, CN, step):
        n1 = min(CN, n0 + step)
        rows = slice(n0 * P, n1 * P)
        parts.append(_bank_slice_plain(
            spec, {k: v[rows] for k, v in flat.items()}, block,
            {k: v[n0:n1] for k, v in prm.items()}, n1 - n0, B, kprog))
    new = {k: torch.cat([pt[0][k] for pt in parts]).reshape(carry[k].shape)
           for k in carry}
    return (new,) + tuple(torch.cat([pt[i] for pt in parts]).reshape(CN, P)
                          for i in (1, 2, 3))


def bank_ring_plain(carry: Dict[str, torch.Tensor], count: torch.Tensor,
                    lmt: torch.Tensor, lmk: torch.Tensor, ring: int):
    """The match ring in plain PyTorch, per pattern (rows of the [CN, P]
    lane outputs against the final carry): ``(total [CN],)`` when ring is
    0, else ``(total, ring_cnt, ring_pid, ring_caps [CN, ring, R, C],
    ring_ts, ring_ok)``.  The ring is the ``ring`` lanes with the most
    matches, ties to the lower lane (``lax.top_k``'s order: a stable
    descending sort); each holds the captures of its last matched slot in
    the final carry, that match's ts, and whether the slot still holds it
    (not re-armed since: ``slot_start <= ts``)."""
    CN, P = (int(x) for x in count.shape)
    total = count.sum(dim=1, dtype=torch.int32)
    if not ring:
        return (total,)
    K = int(carry["slot_state"].shape[-1])
    caps = carry["captures"]
    caps = caps.reshape((CN, P, K) + tuple(caps.shape[-2:]))
    pid = torch.sort(count, dim=1, descending=True,
                     stable=True).indices[:, :ring]
    sel_k = lmk.gather(1, pid).long()
    n_ix = torch.arange(CN, device=count.device)[:, None]
    ring_ts = lmt.gather(1, pid)
    ring_ok = carry["slot_start"].reshape(CN, P, K)[n_ix, pid, sel_k] <= \
        ring_ts
    return (total, count.gather(1, pid), _i32(pid), caps[n_ix, pid, sel_k],
            ring_ts, ring_ok)


def nfa_bank_step_plain(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                        block: Dict[str, torch.Tensor],
                        params: Dict[str, torch.Tensor], ring: int = 0,
                        batch_b: Optional[int] = None,
                        kprog: Optional[NfaKernelProgram] = None):
    """The bank step in plain PyTorch — the JAX package's
    ``build_bank_step`` ([N, ...] carry) and ``build_super_bank_step``
    ([C, N, ...]) with the pattern axes flattened: ``(new carry, counts
    [CN])``, or with ``ring > 0`` ``(new carry, (counts, ring_cnt,
    ring_pid, ring_caps, ring_ts, ring_ok))``, all [CN, ...]."""
    new, cnt, lmt, lmk = bank_lanes_plain(spec, carry, block, params,
                                          batch_b, kprog)
    res = bank_ring_plain(new, cnt, lmt, lmk, ring)
    return new, (res if ring else res[0])


def nfa_bank_lanes(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                   block: Dict[str, torch.Tensor],
                   params: Dict[str, torch.Tensor],
                   kprog: Optional[NfaKernelProgram] = None,
                   batch_b: Optional[int] = None, inplace: bool = False):
    """The bank step kernel's function, :func:`bank_lanes_plain`'s
    contract, on the tensors' own device.  CPU tensors run the plain
    version.  CUDA tensors launch csrc/nfa_step.cu's bank step on the
    current stream (counted in ``nfa_bank_step.launches``) for a spec
    inside its class; with ``inplace`` the new carry IS the input carry,
    updated in place.  Anything else raises: no fallback."""
    dev = block["__ts"].device
    if dev.type == "cpu":
        return bank_lanes_plain(spec, carry, block, params, batch_b)
    if kprog is None or kprog.reason is not None:
        raise RuntimeError(
            "nfa_bank_step: spec outside the CUDA kernel's class ("
            f"{'no kernel program' if kprog is None else kprog.reason})")
    if dev.type != "cuda":
        raise RuntimeError(f"nfa_bank_step: no kernel for device {dev}")
    lead = _bank_lead(carry)
    CN = int(np.prod(lead)) if lead else 1
    P, T = (int(x) for x in block["__ts"].shape)
    K = spec.n_slots
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    G, _L = kernel_geometry(K)
    who = "nfa_bank_step"
    _check("__ts", block["__ts"], torch.int32, (P, T), dev, who)
    _check("__stream", block["__stream"], torch.int32, (P, T), dev, who)
    _check("__valid", block["__valid"], torch.bool, (P, T), dev, who)
    for name in KERNEL_CARRY:
        if name == "armed_total" and not spec.arm_once:
            continue
        shape = {"arm_seq": (P,), "dropped": (P,), "armed_total": (P,),
                 "captures": (P, K, R, C)}.get(name, (P, K))
        _check(name, carry[name], carry_dtype(name), lead + shape, dev, who)
    for name in kprog.param_names:
        _check(name, params[name], torch.float32, lead, dev, who)
    NP = len(kprog.param_names)
    ptab = (torch.stack([params[n].reshape(CN) for n in kprog.param_names],
                        dim=1).contiguous() if NP else
            torch.zeros((1,), dtype=torch.float32, device=dev))
    A = len(kprog.kern_attrs)
    if A == 1:
        attrs = block[kprog.kern_attrs[0]]
        _check("attrs", attrs, torch.float32, (P, T), dev, who)
    elif A:
        attrs = torch.stack([block[a] for a in kprog.kern_attrs])
        _check("attrs", attrs, torch.float32, (A, P, T), dev, who)
    else:
        attrs = torch.zeros((1,), dtype=torch.float32, device=dev)
    gates = kernel_gate_word(spec, kprog, block)
    gates = torch.where(block["__valid"], gates | _VALID_BIT, gates)
    prog = _prog_tensor(spec, kprog, dev)
    new = dict(carry) if inplace else {
        k: torch.empty_like(carry[k]) for k in KERNEL_CARRY if k in carry}
    i32 = dict(dtype=torch.int32, device=dev)
    count, lmt, lmk = (torch.empty((CN, P), **i32) for _ in range(3))
    armed_in = carry.get("armed_total")
    armed_out = new.get("armed_total")
    lib = load_kernel("nfa_step")
    rc = lib.nfa_bank_step(
        attrs.data_ptr(), block["__ts"].data_ptr(),
        block["__stream"].data_ptr(), gates.data_ptr(), prog.data_ptr(),
        prog.numel(), ptab.data_ptr(), NP,
        *[carry[k].data_ptr() for k in KERNEL_CARRY[:7]],
        armed_in.data_ptr() if armed_in is not None else None,
        *[new[k].data_ptr() for k in KERNEL_CARRY[:7]],
        armed_out.data_ptr() if armed_out is not None else None,
        count.data_ptr(), lmt.data_ptr(), lmk.data_ptr(),
        CN, P, T, K, G, A, R * C, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nfa_bank_step: launch failed with CUDA error "
                           f"{rc}")
    nfa_bank_step.launches += 1
    return new, count, lmt, lmk


def nfa_bank_ring(carry: Dict[str, torch.Tensor], count: torch.Tensor,
                  lmt: torch.Tensor, lmk: torch.Tensor, ring: int):
    """The ring kernel's function, :func:`bank_ring_plain`'s contract, on
    the tensors' own device: the plain version for CPU tensors, else one
    launch of csrc/nfa_step.cu's ring kernel (one CTA per pattern) on the
    current stream, or a raise."""
    dev = count.device
    if dev.type == "cpu":
        return bank_ring_plain(carry, count, lmt, lmk, ring)
    if dev.type != "cuda":
        raise RuntimeError(f"nfa_bank_ring: no kernel for device {dev}")
    CN, P = (int(x) for x in count.shape)
    K = int(carry["slot_state"].shape[-1])
    R, C = (int(x) for x in carry["captures"].shape[-2:])
    for name, t in (("count", count), ("lmt", lmt), ("lmk", lmk)):
        _check(name, t, torch.int32, (CN, P), dev, "nfa_bank_ring")
    caps, start = carry["captures"], carry["slot_start"]
    if caps.numel() != CN * P * K * R * C or start.numel() != CN * P * K or \
            not (caps.is_contiguous() and start.is_contiguous()):
        raise ValueError("nfa_bank_ring: carry does not match the counts")
    if ring < 0 or ring > P or 8 * ring > 227 * 1024:
        raise ValueError(f"nfa_bank_ring: ring {ring} outside [0, "
                         f"min(P, 29056)]")
    i32 = dict(dtype=torch.int32, device=dev)
    total = torch.empty((CN,), **i32)
    r = max(ring, 1)
    ring_cnt = torch.empty((CN, r), **i32)
    ring_pid = torch.empty((CN, r), **i32)
    ring_caps = torch.empty((CN, r, R, C), dtype=torch.float32, device=dev)
    ring_ts = torch.empty((CN, r), **i32)
    ring_ok = torch.empty((CN, r), dtype=torch.bool, device=dev)
    lib = load_kernel("nfa_step")
    rc = lib.nfa_bank_ring(
        count.data_ptr(), lmt.data_ptr(), lmk.data_ptr(), caps.data_ptr(),
        start.data_ptr(), total.data_ptr(), ring_cnt.data_ptr(),
        ring_pid.data_ptr(), ring_caps.data_ptr(), ring_ts.data_ptr(),
        ring_ok.data_ptr(), CN, P, K, R * C, ring,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nfa_bank_ring: launch failed with CUDA error "
                           f"{rc}")
    nfa_bank_ring.launches += 1
    if not ring:
        return (total,)
    return total, ring_cnt, ring_pid, ring_caps, ring_ts, ring_ok


#: launches of the ring kernel since the last reset (plain runs excluded)
nfa_bank_ring.launches = 0


def nfa_bank_step(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                  block: Dict[str, torch.Tensor],
                  params: Dict[str, torch.Tensor], ring: int = 0,
                  kprog: Optional[NfaKernelProgram] = None,
                  batch_b: Optional[int] = None, inplace: bool = False):
    """One bank step on the tensors' own device, :func:`nfa_bank_step_plain`'s
    contract: ``(new carry, counts [CN])`` or, with ``ring > 0``, ``(new
    carry, (counts, ring_cnt, ring_pid, ring_caps, ring_ts, ring_ok))``.

    CPU tensors run :func:`nfa_bank_step_plain`.  CUDA tensors launch the
    two kernels of csrc/nfa_step.cu on the current stream, the bank step
    (:func:`nfa_bank_lanes`) and then the ring (:func:`nfa_bank_ring`, the
    per-pattern totals alone when ring is 0), for a spec inside the
    kernel's class; anything else, and a failed build, load or launch,
    raises.  With ``inplace`` (CUDA) the carry is updated in place;
    otherwise the input carry survives."""
    if block["__ts"].device.type == "cpu":
        return nfa_bank_step_plain(spec, carry, block, params, ring,
                                   batch_b)
    new, cnt, lmt, lmk = nfa_bank_lanes(spec, carry, block, params, kprog,
                                        batch_b, inplace)
    res = nfa_bank_ring(new, cnt, lmt, lmk, ring)
    return new, (res if ring else res[0])


#: launches of the bank step kernel since the last reset (plain runs
#: excluded); the ring kernel counts in ``nfa_bank_ring.launches``
nfa_bank_step.launches = 0
