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
  - the hand-written Hopper kernels ``csrc/nfa_step.cu`` (and
    ``csrc/nfa_wide.cu``, the widened instance) — the step with
    the egress compaction fused behind it, launched by
    :func:`nfa_step_egress` for CUDA tensors, for the specs of its class
    (:func:`kernel_class_reason`): every unit kind, PATTERN and
    SEQUENCE, every `every` form, leading min-0 counts and absent units,
    optional `within` and telemetry; the specs beyond the simple, count
    and absent units of PATTERN with a leading `every` run its widened
    template instance (:func:`kernel_wide`).  Its conditions arrive as a
    block-wide capture-free gate per condition plus a table of ``<event
    lane> <cmp> <capture lane>`` compares, one of ``<capture lane> <cmp>
    <constant>`` compares and,
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
of the plain step); on CUDA two kernels: the bank step (per-lane match
count and last match; ``csrc/nfa_step.cu``, and ``csrc/nfa_wide.cu`` for
the widened programs) and the match ring of ``csrc/nfa_step.cu`` (each
pattern's top-``ring`` lanes and their payloads), for every spec of the
step's class.
"""
from __future__ import annotations

import ctypes
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..plan import nfa_program as npg
from ._kernels import load_kernel
# the host packer, where the JAX package keeps it (ops/nfa.py:1294)
from .pack import pack_blocks  # noqa: F401

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


def spec_batch_b(spec: "NfaSpec", batch_b: Optional[int] = None) -> int:
    """The B a step of ``spec`` runs at: ``batch_b``, else the spec's own
    (else the BATCH_ENV default), through :func:`resolve_batch_b`."""
    return resolve_batch_b(spec.batch_b or None) if batch_b is None \
        else resolve_batch_b(batch_b)


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
    ``param_names[param]``; ``ccmp[i]`` its conjuncts ``(row, lane, op,
    constant)``: capture lane ``(row, lane)`` ``CMP_OPS[op]`` the float32
    ``constant``; ``prog[i]`` its program (plan/nfa_program.py: the AND
    of the conjuncts no table takes, and the guards; empty: none), words
    ``op | arg << 8`` with an event lane by its kern_attrs index, a
    capture lane ``(row, lane)`` as ``row * C + lane``, a pattern
    constant by its param_names index and a constant by its index in
    ``pconst[i]`` (float32 values).  ``row_src`` is, per capture lane
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
    ccmp: Tuple[Tuple[Tuple[int, int, int, float], ...], ...] = ()
    prog: Tuple[Tuple[int, ...], ...] = ()
    pconst: Tuple[Tuple[float, ...], ...] = ()


#: mid-chain `every` groups the widened instance holds a clone rank for
MAX_MID_EVERY = 4


def kernel_class_reason(spec: NfaSpec) -> Optional[str]:
    """The first structural feature of ``spec`` outside the CUDA kernel's
    class, or None.  The class is the JAX step's: every unit kind, PATTERN
    and SEQUENCE, every `every` form, leading min-0 counts and absent
    units, `within`, telemetry — with at most 31 conditions (bit 31 of
    the gate word is the event's __valid) and MAX_MID_EVERY mid-chain
    `every` groups.  The condition forms are checked by the compiler
    (NfaKernelProgram.reason)."""
    if len(spec.cond_fns) > 31:
        return "more than 31 conditions"
    if len(spec.mid_every) > MAX_MID_EVERY:
        return f"more than {MAX_MID_EVERY} mid-chain `every` groups"
    return None


def _structural_wide(spec: NfaSpec) -> Optional[str]:
    """The first feature of ``spec`` beyond the simple, count and absent
    units of PATTERN with a leading `every` (or none), no telemetry, or
    None."""
    if _has(spec, "logical"):
        return "logical and/or states"
    if spec.eps_start:
        return "a leading min-0 kleene count (<0:n>) state"
    if spec.lead_absent:
        return "a leading absent (`not ... for`) state"
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
    return None


def _first_reads(kprog: NfaKernelProgram, spec: NfaSpec) -> bool:
    """True when unit 0's condition has a capture compare or a program
    (the simple instances arm on its gate bit alone)."""
    c0 = spec.units[0].cond_a
    return bool(kprog.cmp[c0]) or bool(kprog.prog and kprog.prog[c0])


def kernel_has_prog(kprog: NfaKernelProgram) -> bool:
    """True when a condition has a program: the step launches from the
    build variant whose instances run them (ops/_kernels.VARIANTS)."""
    return any(kprog.prog)


def kernel_wide(spec: NfaSpec, kprog: NfaKernelProgram) -> bool:
    """True when the step runs csrc/nfa_wide.cu's widened template
    instance: a structural feature beyond the simple, count and absent
    units of PATTERN with a leading `every` (:func:`_structural_wide`), a
    ``<capture> <cmp> <constant>`` compare, or a capture compare or a
    program in unit 0's condition (read, as the plain step reads it,
    against slot 0).  A program elsewhere runs in either instance."""
    return _structural_wide(spec) is not None or \
        any(kprog.ccmp) or _first_reads(kprog, spec)


def bank_class_reason(spec: NfaSpec,
                      kprog: NfaKernelProgram) -> Optional[str]:
    """The first feature outside the pattern bank's kernels (K3), or
    None: they take the step's whole class (K2's), the programs of
    :func:`kernel_wide` on the bank's widened instance."""
    return kprog.reason or kernel_class_reason(spec)


#: the program's operations as torch ops (csrc/nfa_step.cuh eval_prog)
_PROG_UNARY = {npg.OP_ABS: torch.abs, npg.OP_FLOOR: torch.floor,
               npg.OP_CEIL: torch.ceil, npg.OP_SQRT: torch.sqrt,
               npg.OP_ROUND: torch.round, npg.OP_NOT: torch.logical_not}
_PROG_BINARY = {npg.OP_ADD: torch.add, npg.OP_SUB: torch.sub,
                npg.OP_MUL: torch.mul, npg.OP_DIV: torch.div,
                npg.OP_MOD: torch.fmod, npg.OP_MAX: torch.maximum,
                npg.OP_MIN: torch.minimum, npg.OP_AND: torch.logical_and,
                npg.OP_OR: torch.logical_or}


def _model_program(kprog: NfaKernelProgram, event, i: int,
                   caps: torch.Tensor) -> torch.Tensor:
    """Condition i's program as csrc/nfa_step.cuh's ``eval_prog`` runs
    it, one torch op a word: operands [P, 1] (event lanes, pattern
    constants), [P, K'] (capture lanes of ``caps``) or 0-d (constants),
    every value float32 → [P, K'] broadcastable bool."""
    C = caps.shape[3]
    stack: List[torch.Tensor] = []
    for w in kprog.prog[i]:
        op, x = w & 0xff, w >> 8
        if op == npg.OP_EV:
            stack.append(event[kprog.kern_attrs[x]][:, None])
        elif op == npg.OP_CAP:
            stack.append(caps[:, :, x // C, x % C])
        elif op == npg.OP_PRM:
            stack.append(event[kprog.param_names[x]][:, None])
        elif op == npg.OP_K:
            stack.append(torch.tensor(kprog.pconst[i][x], dtype=torch.float32,
                                      device=caps.device))
        elif op in _PROG_UNARY:
            stack.append(_PROG_UNARY[op](stack.pop()))
        else:
            b = stack.pop()
            fn = _CMP_FNS[x] if op == npg.OP_CMP else _PROG_BINARY[op]
            stack.append(fn(stack.pop(), b))
    return stack[0].to(torch.bool)


def _model_cond(kprog: NfaKernelProgram, event, i: int,
                caps: torch.Tensor) -> torch.Tensor:
    """Condition i as the kernel computes it: gate bit AND every param
    compare (the lane's pattern constants ride the event dict by name)
    AND every capture compare of its table AND its program against
    ``caps`` ([P, K, R, C], or [P, 1, R, C] zeros) → [P, K'] bool."""
    ok = ((event[KGATE] >> i) & 1).bool()[:, None]
    for attr, prm, op in (kprog.pcmp[i] if kprog.pcmp else ()):
        ok = ok & _CMP_FNS[op](event[kprog.kern_attrs[attr]],
                               event[kprog.param_names[prm]])[:, None]
    for attr, row, lane, op in kprog.cmp[i]:
        x = event[kprog.kern_attrs[attr]][:, None]
        ok = ok & _CMP_FNS[op](x, caps[:, :, row, lane])
    for row, lane, op, c in (kprog.ccmp[i] if kprog.ccmp else ()):
        ok = ok & _CMP_FNS[op](caps[:, :, row, lane], torch.tensor(
            c, dtype=torch.float32, device=caps.device))
    if kprog.prog and kprog.prog[i]:
        ok = ok & _model_program(kprog, event, i, caps)
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
    are hoisted block-wide first, as in the JAX package, and the block is
    padded to a multiple of B with invalid rows (:func:`_pad_block_t`).
    With ``kprog`` every condition is computed from the kernel's inputs
    instead (its gate word and compare tables): the CPU model of
    csrc/nfa_step.cu, padded alike."""
    B = spec_batch_b(spec, batch_b)
    events = dict(block)
    T = int(events["__ts"].shape[1])
    if kprog is not None:
        events[KGATE] = kernel_gate_word(spec, kprog, events)
    elif B > 1:
        events.update(_hoist_cond_gates(spec, events))
    if B > 1:
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


def build_block_step(spec: NfaSpec, batch_b: Optional[int] = None):
    """The JAX package's ``build_block_step`` under its name: a callable
    ``(carry, block) → (new carry, (mask, caps, ts, enter, seq))`` that
    runs :func:`nfa_block_step_plain` at ``batch_b`` events a tick (the
    block's T padded up to a multiple of B, ceil(T / B) ticks)."""
    def step(carry, block):
        return nfa_block_step_plain(spec, carry, block, batch_b)
    return step


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

#: carry leaves the kernel reads and writes, in its argument order (a
#: spec's carry holds the last four only with arm_once, count units and
#: absent units: the kernel gets null pointers for the others)
KERNEL_CARRY = ("slot_state", "slot_start", "slot_enter", "slot_seq",
                "arm_seq", "captures", "dropped", "armed_total", "cnt_cur",
                "cnt_prev", "deadline")


def _leaf_shape(name: str, K: int, R: int, C: int) -> Tuple[int, ...]:
    """A kernel carry leaf's shape after the lane axis."""
    return {"arm_seq": (), "dropped": (), "armed_total": (),
            "captures": (K, R, C)}.get(name, (K,))


#: the carry leaves the step's widened instance reads and writes besides
#: KERNEL_CARRY (logical units, SEQUENCE's leading min-0 count,
#: telemetry), passed after it by the step and the gang
WIDE_CARRY = ("lmask", "seq_froze", "telem")


def _carry_ptrs(carry: Dict[str, torch.Tensor],
                names=KERNEL_CARRY) -> List[Optional[int]]:
    """``names``' data pointers, None for a leaf the carry lacks."""
    return [carry[k].data_ptr() if k in carry else None for k in names]

#: threads per CTA of csrc/nfa_step.cu's step kernel
KERNEL_THREADS = 256

#: bit 31 of the kernel's gate word carries the event's __valid
_VALID_BIT = -(2 ** 31)

_PROG_CACHE: Dict[tuple, tuple] = {}


def kernel_geometry(n_slots: int) -> Tuple[int, int]:
    """(G, L) of csrc/nfa_step.cu for a ring of K = ``n_slots``: G
    threads per lane (K rounded up to a power of two, at most 32; thread
    ``g`` owns slots g, g + G, ...) and L = 256 / G lanes per CTA."""
    G = min(32, 1 << max(int(n_slots) - 1, 0).bit_length())
    return G, KERNEL_THREADS // G


def default_segment(lanes_per_cta: int) -> int:
    """Scratch rows per CTA to start with: four matches per lane."""
    return 4 * lanes_per_cta


#: unit kinds as csrc/nfa_step.cu numbers them
UNIT_KINDS = ("simple", "count", "absent", "logical")
#: words of csrc/nfa_step.cu's program header, of one unit's entry and of
#: one unit's entry in the widened table
PROG_HEADER = 24
UNIT_WORDS = 11
WIDE_UNIT_WORDS = 4
#: the header's words from 12 on: the widened instance's
WIDE_HEADER = ("wide", "is_sequence", "is_every", "every_group_end",
               "tail_every_start", "eps_start", "lead_absent", "dead_start",
               "telemetry", "has_logical", "n_mid", "n_ccmp")


def _count_row_words(spec: NfaSpec, row: int) -> List[int]:
    """A count row's layout as csrc/nfa_step.cu's ``write_count`` reads
    it: n_first, n_last, the __n lane (-1: none), the e[k] banks, the
    e[last-j] banks and the width of each; then each e[k] bank as (k,
    start, len), each e[last-j] bank's start (j = 1, 2, ...), and the
    last-bank lanes they shift from."""
    ib = spec.idx_banks[row] if spec.idx_banks else ()
    mb = sorted(spec.lastk_banks[row]) if spec.lastk_banks else []
    src = tuple(spec.m_src[row]) if spec.m_src else ()
    if [j for j, _s in mb] != list(range(1, len(mb) + 1)):
        raise ValueError(f"row {row}: e[last-j] banks are not j = 1..n")
    out = [spec.n_first[row], spec.n_last[row] if spec.n_last else 0,
           spec.n_lane[row], len(ib), len(mb), len(src) if mb else 0]
    for k, start, ln in ib:
        out += [k, start, ln]
    return out + [s for _j, s in mb] + (list(src) if mb else [])


def _occ_hi(spec: NfaSpec) -> int:
    """The last unit of the occupancy gate on arming (``_one_event_step``:
    no slot may sit at units 0..every_group_end), or -1 without one."""
    if (spec.is_every and spec.every_group_end > 0) or \
            spec.units[0].kind in ("count", "logical"):
        return spec.every_group_end
    return -1


def _count_apps(spec: NfaSpec) -> Dict[int, List[int]]:
    """{unit j: the count units, ascending, whose forwarded count keeps
    appending while a slot waits at j}."""
    apps: Dict[int, List[int]] = {}
    for j, u in enumerate(spec.units):
        t, _live0, completed = _land_static(spec, j)
        if u.kind == "count" and not completed:
            apps.setdefault(t, []).append(j)
    return apps


def kernel_prog(spec: NfaSpec, kprog: NfaKernelProgram) -> List[int]:
    """The kernel's static program table (int32), in the layout
    csrc/nfa_step.cu reads:

      S, R, C, has_within, within_ms, arm_once, n_cond, n_cmp, n_pcmp,
      has_count, has_absent, occ_hi, WIDE_HEADER (12 words),
      S × (kind, stream, cond, row, min, max, waiting_ms, land, live0,
           app0, app1),
      R·C × row_src, (R + 1) × rowx_start, the count rows' layouts
      (:func:`_count_row_words`; other rows none),
      (n_cond + 1) × cmp_start, n_cmp × (attr, row, lane, op),
      (n_cond + 1) × pcmp_start, n_pcmp × (attr, param, op),
      S × (stream_b, cond_b, row_b, is_and),
      n_mid × (g0, g1) in ascending g0,
      (n_cond + 1) × ccmp_start, n_ccmp × (row, lane, op, constant's
      float32 bits),
      (n_cond + 1) × prog_start, the programs' words (a constant's
      argument its index among all conditions' constants), the
      constants' float32 bits

    ``occ_hi``: arming waits while a slot of the lane sits at units
    0..occ_hi (-1: never).  Per unit j: ``kind`` a UNIT_KINDS index; ``land`` and ``live0``
    where a slot advancing out of j goes (:func:`_land_static`; land >=
    S: the chain completes); ``app0``, ``app1`` the count units, in
    ascending order, whose forwarded count keeps appending while a slot
    waits at j (-1: none).  ``wide`` is :func:`kernel_wide`; the other
    widened words are the spec's fields of those names (``n_mid``: its
    mid-chain `every` groups, ``n_ccmp``: the capture-to-constant
    compares), read by the widened instance alone."""
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    S = len(spec.units)

    def table(per_cond):
        start, flat = [0], []
        for entries in per_cond:
            for e in entries:
                flat.extend(e)
            start.append(start[-1] + len(entries))
        return start, flat
    cmp_start, cmp = table(kprog.cmp)
    pcmp_start, pcmp = table(kprog.pcmp or [()] * len(kprog.cmp))
    ccmp_start, ccmp = table(
        [[(r, ln, op, int(np.float32(c).view(np.int32)))
          for (r, ln, op, c) in q]
         for q in (kprog.ccmp or [()] * len(kprog.cmp))])
    mids = sorted(spec.mid_every)
    prog = [S, R, C, int(spec.within_ms is not None),
            int(spec.within_ms or 0), int(spec.arm_once),
            len(kprog.cmp), cmp_start[-1], pcmp_start[-1],
            int(_has(spec, "count")), int(_has(spec, "absent")),
            _occ_hi(spec),
            int(kernel_wide(spec, kprog)), int(spec.is_sequence),
            int(spec.is_every), spec.every_group_end, spec.tail_every_start,
            int(spec.eps_start), int(spec.lead_absent), int(spec.dead_start),
            int(spec.telemetry), int(_has(spec, "logical")), len(mids),
            ccmp_start[-1]]
    apps = _count_apps(spec)
    for j, u in enumerate(spec.units):
        t, live0, _c = _land_static(spec, j)
        app = apps.get(j, []) + [-1, -1]
        if len(app) > 4:
            raise ValueError(f"unit {j}: more than two counts append")
        prog += [UNIT_KINDS.index(u.kind), u.stream_a, u.cond_a, u.row_a,
                 u.min_count, u.max_count, u.waiting_ms, t, int(live0),
                 app[0], app[1]]
    count_rows = {u.row_a for u in spec.units
                  if u.kind == "count" and u.row_a >= 0}
    rowx_start, rowx = [0], []
    for r in range(R):
        if r in count_rows:
            rowx += _count_row_words(spec, r)
        rowx_start.append(len(rowx))
    prog += list(kprog.row_src) + rowx_start + rowx + cmp_start + cmp + \
        pcmp_start + pcmp
    for u in spec.units:
        prog += [u.stream_b, u.cond_b, u.row_b, int(u.is_and)]
    for g0, g1 in mids:
        prog += [g0, g1]
    pstart, words, consts = [0], [], []
    for q, kc in zip(kprog.prog or [()] * len(kprog.cmp),
                     kprog.pconst or [()] * len(kprog.cmp)):
        base = len(consts)
        words += [w + (base << 8) if (w & 0xff) == npg.OP_K else w
                  for w in q]
        consts += [int(np.float32(c).view(np.int32)) for c in kc]
        pstart.append(len(words))
    return prog + ccmp_start + ccmp + pstart + words + consts


def _prog_tensor(spec: NfaSpec, kprog: NfaKernelProgram, dev) -> torch.Tensor:
    """The program table on ``dev``, built once per (spec, kernel
    program) pair: a wrapper call only looks it up."""
    key = (id(spec), id(kprog), str(dev))
    hit = _PROG_CACHE.get(key)
    if hit is None or hit[0] is not spec or hit[1] is not kprog:
        hit = _PROG_CACHE[key] = (spec, kprog, torch.tensor(
            kernel_prog(spec, kprog), dtype=torch.int32, device=dev))
    return hit[2]


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


def _check_carry(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                 lead: Tuple[int, ...], dev, who: str) -> None:
    """Every kernel carry leaf the spec's carry has (:func:`make_carry`),
    on ``dev`` with its dtype, ``lead`` axes and the spec's shape."""
    K = spec.n_slots
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    want = {"armed_total": spec.arm_once, "cnt_cur": _has(spec, "count"),
            "cnt_prev": _has(spec, "count"),
            "deadline": _has(spec, "absent"),
            "lmask": _has(spec, "logical"),
            "seq_froze": spec.eps_start and spec.is_sequence,
            "telem": spec.telemetry}
    shape = {"seq_froze": (), "telem": (3 * len(spec.units) + 1,)}
    for name in KERNEL_CARRY + WIDE_CARRY:
        if not want.get(name, True):
            continue
        if name not in carry:
            raise ValueError(f"{who}: the carry has no {name}")
        _check(name, carry[name], carry_dtype(name),
               tuple(lead) + shape.get(name, _leaf_shape(name, K, R, C)),
               dev, who)


def nfa_compact(rows: torch.Tensor, lane_count: torch.Tensor,
                fill: torch.Tensor, dropped: torch.Tensor,
                dl_min: Optional[torch.Tensor], P: int, L: int, seg: int,
                cap: int, width: int) -> torch.Tensor:
    """Launch csrc/nfa_step.cu's compaction: one step's scratch rows
    (``fill`` per CTA, ``lane_count`` per lane) into a new [cap + 2,
    width] egress buffer (slab, tail, status); the tail's column 2 is the
    least of the step's per-CTA earliest absent deadlines ``dl_min`` (None:
    the spec has no absent unit, and the column is 0).  CUDA tensors
    only."""
    dev = fill.device
    buf = torch.empty((cap + 2, width), dtype=torch.int32, device=dev)
    lib = load_kernel("nfa_step")
    rc = lib.nfa_compact(rows.data_ptr(), lane_count.data_ptr(),
                         fill.data_ptr(), dropped.data_ptr(),
                         None if dl_min is None else dl_min.data_ptr(),
                         buf.data_ptr(), P, L, seg, fill.numel(), cap, width,
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nfa_compact: launch failed with CUDA error {rc}")
    nfa_compact.launches += 1
    return buf


#: launches of the compaction kernel since the last reset
nfa_compact.launches = 0


def _step_egress_plain(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                       block: Dict[str, torch.Tensor], cap: int,
                       batch_b: Optional[int]):
    """The plain composition on the tensors' device:
    :func:`nfa_block_step_plain`, then :func:`egress_pack_plain` (and an
    all-zero status row: the plain path has no scratch segments)."""
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    width = 4 + R * C
    dev = block["__ts"].device
    new, outs = nfa_block_step_plain(spec, carry, block, batch_b)
    absent = _has(spec, "absent")
    dl_st = new["slot_state"] if absent else None
    dl = new.get("deadline") if absent else None

    def repack_plain(c: int) -> torch.Tensor:
        return torch.cat([
            egress_pack_plain(spec, *outs, new["dropped"], dl_st, dl, c),
            _status_row(0, 0, width, dev)])
    return new, NfaEgress(repack_plain(cap), repack_plain, 0)


class _KernelCall(NamedTuple):
    """One block's kernel inputs and outputs, checked and allocated
    (:func:`_kernel_call`)."""
    attrs: torch.Tensor
    gates: torch.Tensor
    prog: torch.Tensor
    new: Dict[str, torch.Tensor]
    rows: torch.Tensor
    lane_count: torch.Tensor
    fill: torch.Tensor
    dl_min: Optional[torch.Tensor]
    P: int
    T: int
    K: int
    G: int
    L: int
    seg: int
    A: int
    width: int
    flags: int
    tel_w: int


#: csrc/nfa_step.cu's step flags: the widened instance, and one more
#: `within` pass after the last event at its ts (the invalid rows that
#: pad the plain step's block to a multiple of B, :func:`_pad_block_t`)
FLAG_WIDE = 1
FLAG_PAD_WITHIN = 2


def kernel_flags(spec: NfaSpec, kprog: NfaKernelProgram, T: int,
                 batch_b: Optional[int] = None) -> int:
    """The step's flags for a [P, T] block at B = ``batch_b`` (default
    the spec's), as :func:`nfa_block_step_plain` steps it."""
    B = spec_batch_b(spec, batch_b)
    pad = B > 1 and T % B != 0 and spec.within_ms is not None
    return (FLAG_WIDE if kernel_wide(spec, kprog) else 0) | \
        (FLAG_PAD_WITHIN if pad else 0)


def _kernel_call(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                 block: Dict[str, torch.Tensor],
                 kprog: Optional[NfaKernelProgram], seg: Optional[int],
                 who: str, batch_b: Optional[int] = None) -> _KernelCall:
    """Check one block's tensors against the kernel's class and layout,
    build its gate word (the torch condition programs, K5) and allocate
    the new carry and the step's scratch."""
    dev = block["__ts"].device
    if kprog is None or kprog.reason is not None:
        raise RuntimeError(
            f"{who}: spec outside the CUDA kernel's class ("
            f"{'no kernel program' if kprog is None else kprog.reason})")
    if kprog.param_names:
        raise RuntimeError(f"{who}: a parameterized spec steps through the "
                           f"pattern bank (nfa_bank_step)")
    if dev.type != "cuda":
        raise RuntimeError(f"{who}: no kernel for device {dev}")
    K = spec.n_slots
    R, C = max(spec.n_rows, 1), max(spec.n_caps, 1)
    P, T = block["__ts"].shape
    G, L = kernel_geometry(K)
    n_cta = -(-P // L)
    seg = default_segment(L) if seg is None else int(seg)
    _check("__ts", block["__ts"], torch.int32, (P, T), dev, who)
    _check("__stream", block["__stream"], torch.int32, (P, T), dev, who)
    _check("__valid", block["__valid"], torch.bool, (P, T), dev, who)
    _check_carry(spec, carry, (P,), dev, who)
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
    new = {k: torch.empty_like(carry[k]) for k in KERNEL_CARRY + WIDE_CARRY
           if k in carry}
    width = 4 + R * C
    i32 = dict(dtype=torch.int32, device=dev)
    return _KernelCall(
        attrs=attrs, gates=gates, prog=_prog_tensor(spec, kprog, dev),
        new=new, rows=torch.empty((max(n_cta * seg * (width + 2), 1),),
                                  **i32),
        lane_count=torch.empty((P,), **i32),
        fill=torch.empty((n_cta,), **i32),
        dl_min=(torch.empty((n_cta,), **i32) if "deadline" in carry
                else None),
        P=P, T=T, K=K, G=G, L=L, seg=seg, A=A, width=width,
        flags=kernel_flags(spec, kprog, T, batch_b),
        tel_w=3 * len(spec.units) + 1 if spec.telemetry else 0)


def _repack_of(k: _KernelCall) -> Callable[[int], torch.Tensor]:
    """A step's compaction re-run at another cap, from its scratch."""
    def repack(c: int) -> torch.Tensor:
        return nfa_compact(k.rows, k.lane_count, k.fill, k.new["dropped"],
                           k.dl_min, k.P, k.L, k.seg, c, k.width)
    return repack


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
    if dev.type == "cpu":
        return _step_egress_plain(spec, carry, block, cap, batch_b)
    k = _kernel_call(spec, carry, block, kprog, seg, "nfa_step_egress",
                     batch_b)
    # the widened instance is csrc/nfa_wide.cu's (nfa_step's arguments);
    # a spec with a condition program takes the build variant with them
    prog = kernel_has_prog(kprog)
    step = load_kernel("nfa_wide_prog" if prog else "nfa_wide") \
        .nfa_step_wide if k.flags & FLAG_WIDE else \
        load_kernel("nfa_prog" if prog else "nfa_step").nfa_step
    rc = step(
        k.attrs.data_ptr(), block["__ts"].data_ptr(),
        block["__stream"].data_ptr(), k.gates.data_ptr(), k.prog.data_ptr(),
        k.prog.numel(), *_carry_ptrs(carry), *_carry_ptrs(k.new),
        k.rows.data_ptr(), k.lane_count.data_ptr(), k.fill.data_ptr(),
        None if k.dl_min is None else k.dl_min.data_ptr(),
        *_carry_ptrs(carry, WIDE_CARRY), *_carry_ptrs(k.new, WIDE_CARRY),
        k.P, k.T, k.K, k.G, k.seg, k.A, k.width - 4, k.flags, k.tel_w,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nfa_step: launch failed with CUDA error {rc}")
    nfa_step_egress.launches += 1
    repack = _repack_of(k)
    return k.new, NfaEgress(repack(cap), repack, k.seg)


#: launches of the step kernel since the last reset (plain runs excluded)
nfa_step_egress.launches = 0


# ------------------------------------------------------------ the gang step

class GangTenant(NamedTuple):
    """One packed tenant's pending block (plan/xtenant.py): its spec and
    kernel program, its carry and [P, T] block, its egress cap and scratch
    rows per CTA (None: the kernel's default)."""
    spec: NfaSpec
    carry: Dict[str, torch.Tensor]
    block: Dict[str, torch.Tensor]
    kprog: Optional[NfaKernelProgram] = None
    cap: int = 1024
    seg: Optional[int] = None


class GangEgress(NamedTuple):
    """A gang's egress on the device: ``buf`` [sum(cap_i + 2), W] int32
    holds tenant i's egress buffer (:class:`NfaEgress`: slab, tail,
    status) at row ``offsets[i]``; ``egress[i]`` is tenant i's NfaEgress,
    its ``buf`` a view of ``buf`` and its ``repack`` a compaction of that
    tenant alone.  ``compact`` (CUDA only, else None) re-runs the one
    compaction launch of every tenant into ``buf``."""
    buf: torch.Tensor
    offsets: Tuple[int, ...]
    egress: Tuple[NfaEgress, ...]
    compact: Optional[Callable[[], None]] = None


def _gang_width(tenants: List[GangTenant]) -> int:
    ws = {4 + max(t.spec.n_rows, 1) * max(t.spec.n_caps, 1)
          for t in tenants}
    if len(ws) > 1:
        raise ValueError(f"nfa gang: tenants' egress widths differ {ws}: "
                         f"one bucket shares R and C")
    return ws.pop() if ws else 5


def nfa_gang_step_egress_plain(tenants: List[GangTenant],
                               batch_b: Optional[int] = None):
    """The gang's plain twin on the tensors' device: each tenant's
    :func:`nfa_block_step_plain`, then :func:`egress_pack_plain` at its
    own cap, in list order — the contract of :func:`nfa_step_egress` per
    tenant — with the egress buffers stacked in one ``GangEgress``.
    Returns ``(new carries, GangEgress)``; no input carry is modified."""
    width = _gang_width(tenants)
    news, egs, offsets, off = [], [], [], 0
    for t in tenants:
        new, eg = _step_egress_plain(t.spec, t.carry, t.block, t.cap,
                                     batch_b)
        news.append(new)
        egs.append(eg)
        offsets.append(off)
        off += int(eg.buf.shape[0])
    buf = torch.cat([e.buf for e in egs]) if egs else \
        torch.zeros((0, width), dtype=torch.int32)
    views = tuple(NfaEgress(buf[o:o + int(e.buf.shape[0])], e.repack, e.seg)
                  for o, e in zip(offsets, egs))
    return news, GangEgress(buf, tuple(offsets), views)


#: int64 words a tenant in the gang's host descriptor (csrc/nfa_gang.cu
#: kGangFields): attrs, ts, stream, gates, prog, prog_len, carry in (11,
#: KERNEL_CARRY), carry out (11), rows, lane_count, fill, dl_min, P, T,
#: K, G, seg, A, RC, slab, cap, W, WIDE_CARRY in (3), WIDE_CARRY out
#: (3), flags (FLAG_WIDE, FLAG_PAD_WITHIN), tel_w
GANG_FIELDS = 50


def nfa_gang_step_egress(tenants: List[GangTenant],
                         batch_b: Optional[int] = None):
    """Step every pending tenant of a bucket and compact its matches:
    ``(new carries, GangEgress)``, each tenant's result the one
    :func:`nfa_step_egress` gives it alone.

    CPU tensors run :func:`nfa_gang_step_egress_plain`.  CUDA tensors
    launch csrc/nfa_gang.cu's entry points on the current stream:
    the tenants' descriptors go to the card in one copy, then ONE step
    launch per template instance present (``nfa_gang_step``: a CTA finds
    its tenant by a search over the tenants' CTA prefix and runs the step
    body on that tenant's carry, block and program) and ONE compaction
    launch (``nfa_gang_compact``), which writes every tenant's slab, tail
    and status rows at its offset in the one bucket buffer.  The tenants
    share K and R*C (a bucket's shape key); their programs, attribute
    counts, T and caps differ.  Each tenant's gate word is its own torch
    condition program (K5).  A failed build, load or launch raises: no
    fallback.  No input carry is modified, so one tenant's overflow
    replays alone from its pre-gang carry."""
    if not tenants or tenants[0].block["__ts"].device.type == "cpu":
        return nfa_gang_step_egress_plain(tenants, batch_b)
    dev = tenants[0].block["__ts"].device
    width = _gang_width(tenants)
    calls = [_kernel_call(t.spec, t.carry, t.block, t.kprog, t.seg,
                          "nfa_gang_step_egress", batch_b) for t in tenants]
    if len({(k.K, k.G) for k in calls}) > 1:
        raise ValueError("nfa_gang_step_egress: tenants' K differ (one "
                         "bucket shares K)")
    rows = [t.cap + 2 for t in tenants]
    buf = torch.empty((sum(rows), width), dtype=torch.int32, device=dev)
    desc = np.zeros((len(tenants), GANG_FIELDS), np.int64)
    offsets, off = [], 0
    for i, (t, k, r) in enumerate(zip(tenants, calls, rows)):
        offsets.append(off)
        ptrs = [k.attrs.data_ptr(), t.block["__ts"].data_ptr(),
                t.block["__stream"].data_ptr(), k.gates.data_ptr(),
                k.prog.data_ptr(), k.prog.numel()] + \
            [p or 0 for p in _carry_ptrs(t.carry)] + \
            [p or 0 for p in _carry_ptrs(k.new)] + \
            [k.rows.data_ptr(), k.lane_count.data_ptr(), k.fill.data_ptr(),
             0 if k.dl_min is None else k.dl_min.data_ptr(),
             k.P, k.T, k.K, k.G, k.seg, k.A, width - 4,
             buf.data_ptr() + off * width * 4, t.cap, width] + \
            [p or 0 for p in _carry_ptrs(t.carry, WIDE_CARRY)] + \
            [p or 0 for p in _carry_ptrs(k.new, WIDE_CARRY)] + \
            [k.flags, k.tel_w]
        desc[i] = ptrs
        off += r
    # a bucket with a condition program steps on the gang's build variant
    # with them (every tenant of the call; the compaction is the same)
    lib = load_kernel("nfa_gang_prog" if any(kernel_has_prog(k.kprog)
                                             for k in tenants)
                      else "nfa_gang")
    table = torch.empty((int(lib.nfa_gang_table_bytes(len(tenants))),),
                        dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = (ctypes.c_int * 2)()
    rc = lib.nfa_gang_step(desc.ctypes.data, len(tenants), table.data_ptr(),
                           table.numel(), out, stream)
    if rc != 0:
        raise RuntimeError(f"nfa_gang_step: launch failed with CUDA error "
                           f"{rc}")
    nfa_gang_step_egress.launches += out[0]
    n, n_cta = len(tenants), out[1]

    def compact() -> None:
        nfa_gang_compact(table, n, n_cta, dev)
    compact()
    egs = tuple(NfaEgress(buf[o:o + r], _repack_of(k), k.seg)
                for o, r, k in zip(offsets, rows, calls))
    return [k.new for k in calls], GangEgress(buf, tuple(offsets), egs,
                                              compact)


#: step launches of the gang since the last reset: one a template
#: instance present in a flush (plain runs excluded)
nfa_gang_step_egress.launches = 0


def nfa_gang_compact(table: torch.Tensor, n: int, n_cta: int, dev) -> None:
    """Launch csrc/nfa_gang.cu's compaction over the ``n`` tenants
    (``n_cta`` step CTAs in all) whose descriptors ``nfa_gang_step``
    wrote into ``table`` (on the card): every tenant's scratch rows into
    its place in the bucket buffer.  CUDA tensors only."""
    lib = load_kernel("nfa_gang")
    rc = lib.nfa_gang_compact(table.data_ptr(), n, n_cta,
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nfa_gang_compact: launch failed with CUDA "
                           f"error {rc}")
    nfa_gang_compact.launches += 1


#: launches of the gang compaction since the last reset
nfa_gang_compact.launches = 0


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
    if B > 1:
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
    kernel's inputs instead (the CPU model of the bank step's group and
    widened instances).  B > 1 pads a block whose T is no multiple of B
    with invalid rows at the last event's ts, as the plain step does:
    they run only `within` expiry, the kernels' one more `within` pass
    there (FLAG_PAD_WITHIN).  Functional: the input carry is not
    modified."""
    B = spec_batch_b(spec, batch_b)
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


#: csrc/nfa_step.cu's bank thread instance takes K up to this many slots
#: (in registers) and this many constant compares (in registers)
BANK_THREAD_MAX_K = 16
BANK_THREAD_MAX_PCMP = 8
#: its lanes a tile (csrc's kBankLanes): a warp is 32 lanes of one pattern
BANK_LANES = 32
#: a block of up to BANK_BLOCK_BYTES a CTA's lanes is staged whole, and
#: the CTA walks BANK_GROUPS groups of patterns over it; a longer one is
#: tiled over T in two buffers of BANK_TILE_BYTES together, one group a
#: CTA; and the shared memory a CTA may have on Hopper
BANK_BLOCK_BYTES = 48 * 1024
BANK_GROUPS = 4
BANK_TILE_BYTES = 32 * 1024
SMEM_LIMIT = 227 * 1024


class BankGeometry(NamedTuple):
    """The bank step's instance for a launch: ``"thread"`` (one thread
    per (pattern, lane), ``nfa_bank_thread_kernel``) or ``"wide_thread"``
    (the same mapping on the widened unit loop, csrc/nfa_bank_wide.cu's
    ``nfa_bank_wide_kernel``) with its tile of TT events, the pattern
    groups a CTA walks over it and its shared memory in bytes, or
    ``"group"`` (a group of G threads per lane, ``nfa_bank_step_kernel``
    of csrc/nfa_step.cu) or ``"wide"`` (the same mapping on the widened
    unit loop, csrc/nfa_wide.cu's ``nfa_bank_step_kernel``), the rest 0
    (the C entry plans its shared memory)."""
    instance: str
    TT: int
    smem: int
    groups: int = 0


def bank_wide_arrays(spec: NfaSpec) -> int:
    """The widened thread instance's per-slot arrays of an event
    (nfa_step.cuh ``Wide::arr``): the states the unit loop starts from;
    the pending ranks with a trailing or mid-chain `every`; the clones'
    sources and starts and a rank per mid-chain group with mid-chain
    `every`."""
    n_mid = len(spec.mid_every)
    rk = int(n_mid > 0 or spec.tail_every_start >= 0)
    return 1 + rk + (2 + n_mid if n_mid else 0)


def bank_wide_words(spec: NfaSpec, K: int, RC: int) -> int:
    """Words of a thread's shared-memory column in the widened thread
    instance (csrc/nfa_bank_wide.cu ``wide_rows``): the captures; rows of
    K words for enter, seq, state, start, the deadline (absent units),
    cnt_cur and cnt_prev (count units), lmask (logical units) and the
    event's arrays (:func:`bank_wide_arrays`); the telemetry row."""
    rows = 4 + int(_has(spec, "absent")) + 2 * int(_has(spec, "count")) + \
        int(_has(spec, "logical")) + bank_wide_arrays(spec)
    tel_w = 3 * len(spec.units) + 1 if spec.telemetry else 0
    return K * RC + K * rows + tel_w


def wide_need_table(spec: NfaSpec) -> List[int]:
    """csrc/nfa_bank_wide.cu's ``need_of`` per unit j: the conditions a
    slot waiting at j can read in an event — its unit's (both sides of a
    logical one), those of the count units whose forwarded count appends
    while it waits there, and for an absent unit those of the unit a due
    deadline lands it at (SEQUENCE confirms it before the event steps),
    transitively."""
    units = spec.units
    S = len(units)
    apps = _count_apps(spec)
    out = []
    for j0 in range(S):
        r, j, hop = 0, j0, 0
        while 0 <= j < S and hop <= S:
            u = units[j]
            if u.cond_a >= 0:
                r |= 1 << u.cond_a
            if u.kind == "logical" and u.cond_b >= 0:
                r |= 1 << u.cond_b
            for a in apps.get(j, ()):
                r |= 1 << units[a].cond_a
            if u.kind != "absent":
                break
            j = _land_static(spec, j)[0]
            hop += 1
        out.append(r)
    return out


def bank_first_reads(spec: NfaSpec, kprog: NfaKernelProgram) -> bool:
    """True when unit 0's conditions read slot 0's captures (a capture
    compare, a capture-to-constant compare or a program): arming reads
    them whatever slot 0 holds."""
    u0 = spec.units[0]
    conds = [c for c in (u0.cond_a, u0.cond_b if u0.kind == "logical"
                         else -1) if c >= 0]
    return any(kprog.cmp[c] or (kprog.ccmp and kprog.ccmp[c]) or
               (kprog.prog and kprog.prog[c]) for c in conds)


def bank_geometry(K: int, T: int, A: int, RC: int, n_pcmp: int,
                  n_params: int, prog_len: int, count: bool = False,
                  absent: bool = False, n_cond: int = 1,
                  wide: bool = False, wide_words: int = 0,
                  n_units: int = 0) -> BankGeometry:
    """The instance csrc/nfa_step.cu's bank step runs for K slots, T
    events a lane, A attribute lanes, R·C capture words a slot, n_pcmp
    constant compares over n_params constants a pattern and a program
    of prog_len words, for a spec of n_cond conditions with kleene count
    units (``count``) and absent units (``absent``): the thread instance
    when K and the compares fit its registers and its shared memory (the
    program; the CTA's patterns' constants; each compare's interval per
    pattern of the CTA and their union; 128 candidate bits a lane and
    condition; one tile of TT events of ts, stream, gate word and
    attribute lanes for the CTA's lanes — two when T is tiled; each
    thread's column of capture, enter and seq words, of deadlines with
    absent units, and of cnt_cur, cnt_prev, state and start words with
    count units) fits the CTA's; else the group instance.  Both take
    the simple, count and absent units of PATTERN with a leading `every`
    and condition programs (from the build variant with them).  A
    widened program (``wide``: :func:`kernel_wide`) runs the widened
    thread instance within the same limits, its column ``wide_words``
    words a thread (:func:`bank_wide_words`) beside a need table of
    ``n_units`` words, else the widened group instance.  TT: a power of
    two from 4 to 128, the smallest that holds T; where that tile
    exceeds BANK_BLOCK_BYTES, cut to BANK_TILE_BYTES.  The layout is
    csrc's ``bank_layout`` (and ``wide_layout``); the launch refuses a
    size below it."""
    other = "wide" if wide else "group"
    if K > BANK_THREAD_MAX_K or n_pcmp > BANK_THREAD_MAX_PCMP:
        return BankGeometry(other, 0, 0)
    if wide and (wide_words <= 0 or n_units <= 0):
        raise ValueError("bank_geometry: a widened program needs its "
                         "column's words and its units")
    lanes = BANK_LANES

    def tile_bytes(tt):
        stride = tt if (tt >> 2) & 1 else tt + 4
        return (2 if T > tt else 1) * (3 + A) * lanes * stride * 4
    tt = 4
    while tt < T and tt < 128:
        tt *= 2
    groups = BANK_GROUPS
    if T > tt or tile_bytes(tt) > BANK_BLOCK_BYTES:
        groups = 1
        while tt > 4 and tile_bytes(tt) > BANK_TILE_BYTES:
            tt //= 2
    patterns = KERNEL_THREADS // lanes * groups
    column = KERNEL_THREADS * wide_words * 4 + ((n_units + 3) & ~3) * 4 \
        if wide else \
        KERNEL_THREADS * K * (RC + 2 + int(absent) + 4 * int(count)) * 4
    smem = ((prog_len + 3) & ~3) * 4 + \
        ((patterns * n_params + 3) & ~3) * 4 + \
        BANK_THREAD_MAX_PCMP * (patterns + 1) * 16 + \
        ((n_cond * lanes * 4 + 3) & ~3) * 4 + \
        tile_bytes(tt) + column
    if smem > SMEM_LIMIT:
        return BankGeometry(other, 0, 0)
    return BankGeometry("wide_thread" if wide else "thread", tt, smem,
                        groups)


def pcmp_bounds(op: int, c: torch.Tensor):
    """csrc/nfa_step.cu's ``pcmp_bounds``: ``x CMP_OPS[op] c`` for float32
    constants c as ``(lo, hi, inv)`` with ``x op c == ((lo <= x) & (x <=
    hi)) != inv`` for every float32 x (a NaN x is in no interval; a NaN c
    gives the empty one)."""
    c = c.to(torch.float32)
    inf = torch.full_like(c, float("inf"))
    lo, hi = -inf, inf
    if op == 0:
        empty = c == -inf
        lo = torch.where(empty, inf, lo)
        hi = torch.where(empty, -inf, torch.nextafter(c, -inf))
    elif op == 1:
        hi = c
    elif op == 2:
        empty = c == inf
        lo = torch.where(empty, inf, torch.nextafter(c, inf))
        hi = torch.where(empty, -inf, hi)
    elif op == 3:
        lo = c
    else:
        lo = hi = c
    return lo, hi, op == 5


def bank_thread_model(spec: NfaSpec, carry: Dict[str, torch.Tensor],
                      block: Dict[str, torch.Tensor],
                      params: Dict[str, torch.Tensor],
                      kprog: NfaKernelProgram,
                      cta_patterns: int = 8 * BANK_GROUPS,
                      batch_b: Optional[int] = None):
    """The CPU model of csrc/nfa_step.cu's bank thread instance and of
    csrc/nfa_bank_wide.cu's widened one, with :func:`bank_lanes_plain`'s
    contract: each (pattern, lane) row is one thread, ``cta_patterns``
    consecutive patterns share a CTA.

    Per row an event is a candidate of the CTA when it is ``__valid``
    and keeps a bit of the conditions the row needs after the CTA's
    union of each constant compare's :func:`pcmp_bounds` intervals (`!=`
    left out); a candidate is live for the row when such a bit survives
    its pattern's own compares; every other event is dead.  The row
    needs every condition when the spec has neither absent nor count
    units; else unit 0's (arming), those of the units its slots wait at,
    and those of the count units whose forwarded count a waiting slot
    appends to (the kernel's ``needs``, from the row's states before the
    event).  A live event takes the plain step's order
    (``_one_event_step``: `within`, each slot's one transition against
    its captures — a program included — the live appends, arming behind
    the occupancy gate, the deadline pass).  The kernel runs none of a
    dead event's conditions: it expires the row's live slots (state >= 1)
    whose `within` the event fails and, when the event is ``__valid``,
    runs the deadline pass — the plain step with every condition of the
    row failing, which is how the model steps it (its gate word zero).
    After the block, when the plain step pads it to a multiple of B
    (``batch_b``, default the spec's) and the spec has a `within`, one
    more expiry at the last event's ts (the count instance's pass: a slot
    that left a leading count at the last event may expire there).

    A widened program (:func:`kernel_wide`) needs unit 0's conditions, a
    leading min-0 count's unit 1's, and per slot those of
    :func:`wide_need_table` at its state; a dead event is the plain step
    with the row's gate word zero, as above (the kernel cuts it to
    `within` expiry and telemetry fails only where that is the same), and
    the padding rows are one invalid event at the last event's ts (its
    `within` pass, telemetry and occupancy gauge).  Functional: the input
    carry is not modified."""
    lead = _bank_lead(carry)
    CN = int(np.prod(lead)) if lead else 1
    P, T = (int(x) for x in block["__ts"].shape)
    rows = CN * P
    dev = block["__ts"].device
    c = {k: v.reshape((rows,) + tuple(v.shape[len(lead) + 1:]))
         for k, v in carry.items()}

    def lanes(v):                      # [P, T] → one row per thread
        return v.repeat((CN,) + (1,) * (v.dim() - 1))
    events = {k: lanes(v) for k, v in block.items()}
    for name in kprog.param_names:
        events[name] = params[name].reshape(CN).to(torch.float32) \
            .repeat_interleave(P)[:, None].expand(rows, T)
    gates = lanes(kernel_gate_word(spec, kprog, block))
    attrs = [lanes(block[a].to(torch.float32)) for a in kprog.kern_attrs]
    bounds, union = [], []
    pad = -CN % cta_patterns
    for i, entries in enumerate(kprog.pcmp):
        for attr, prm, op in entries:
            lo, hi, inv = pcmp_bounds(
                op, params[kprog.param_names[prm]].reshape(CN))
            bounds.append((1 << i, attr, lo.repeat_interleave(P),
                           hi.repeat_interleave(P), inv))
            if inv:
                continue
            # a NaN bound is an empty interval (fminf / fmaxf skip it)
            ulo = torch.nn.functional.pad(
                torch.where(lo.isnan(), float("inf"), lo), (0, pad),
                value=float("inf")).reshape(-1, cta_patterns).amin(dim=1)
            uhi = torch.nn.functional.pad(
                torch.where(hi.isnan(), -float("inf"), hi), (0, pad),
                value=-float("inf")).reshape(-1, cta_patterns).amax(dim=1)
            union.append((1 << i, attr,
                          ulo.repeat_interleave(cta_patterns)[:CN]
                          .repeat_interleave(P),
                          uhi.repeat_interleave(cta_patterns)[:CN]
                          .repeat_interleave(P)))
    cmask = (1 << len(kprog.cmp)) - 1
    # the conditions a slot at each state needs (state S: an empty slot),
    # and those every row needs
    units = spec.units
    wide = kernel_wide(spec, kprog)
    if wide:
        wait = wide_need_table(spec) + [0]
        need0 = wait[0] | (wait[1] if spec.eps_start and len(units) > 1
                           else 0)
    else:
        wait = [0] * (len(units) + 1)
        for j, u in enumerate(units):
            t, _l0, completed = _land_static(spec, j)
            wait[j] |= 1 << u.cond_a
            if u.kind == "count" and not completed:
                wait[t] |= 1 << u.cond_a
        need0 = 1 << units[0].cond_a
    narrow = wide or _has(spec, "absent") or _has(spec, "count")
    wait_t = torch.tensor(wait, dtype=torch.int32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    cnt, lmt, lmk = (torch.zeros((rows,), **i32) for _ in range(3))
    for j in range(T):
        ev = {k: v[:, j] for k, v in events.items()}
        need = torch.full((rows,), cmask, **i32)
        if narrow:
            st = c["slot_state"]
            need = torch.full((rows,), need0, **i32)
            per = wait_t[torch.where(st >= 0, st, len(units)).long()]
            for s in range(spec.n_slots):
                need = need | per[:, s]
        gw = gates[:, j]
        ugw, ogw = gw, gw
        for bit, attr, lo, hi in union:
            x = attrs[attr][:, j]
            ugw = torch.where((x >= lo) & (x <= hi), ugw, ugw & ~bit)
        for bit, attr, lo, hi, inv in bounds:
            x = attrs[attr][:, j]
            ok = ((x >= lo) & (x <= hi)) != inv
            ogw = torch.where(ok, ogw, ogw & ~bit)
        full = ev["__valid"] & ((ugw & need) != 0) & ((ogw & need) != 0)
        ev[KGATE] = torch.where(full, gw, 0)
        c, (mm, *_rest) = _one_event_step(spec, c, ev, kprog)
        hit = mm.any(dim=1)
        cnt = cnt + _count(mm)
        lmt = torch.where(hit, ev["__ts"], lmt)
        lmk = torch.where(hit, _i32(_first_true(mm)), lmk)
    B = spec_batch_b(spec, batch_b)
    if B > 1 and T % B and spec.within_ms is not None and wide:
        pad = {k: torch.zeros_like(v[:, T - 1]) for k, v in events.items()}
        pad["__ts"] = events["__ts"][:, T - 1]
        pad[KGATE] = torch.zeros((rows,), **i32)
        c, _y = _one_event_step(spec, c, pad, kprog)
    elif B > 1 and T % B and spec.within_ms is not None:
        c = dict(c)
        tl = events["__ts"][:, T - 1:T]
        c["slot_state"] = torch.where(
            (c["slot_state"] >= 1) &
            (tl - c["slot_start"] > spec.within_ms), -1, c["slot_state"])
    new = {k: c[k].reshape(carry[k].shape) for k in carry}
    return (new,) + tuple(x.reshape(CN, P) for x in (cnt, lmt, lmk))


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
    total = count.sum(dim=1, dtype=torch.int32)
    if not ring:
        return (total,)
    pid = torch.sort(count, dim=1, descending=True,
                     stable=True).indices[:, :ring]
    return (total,) + _ring_payload(carry, count, lmt, lmk, pid)


#: csrc/nfa_step.cu's ring kernel: warps a CTA, the int32 words of its two
#: reduction buffers, and the lane multiple of a tile when a row is tiled
RING_WARPS = 8
RING_RED_INTS = 2 * RING_WARPS * 3
RING_TILE_ALIGN = 128


class RingGeometry(NamedTuple):
    """The ring kernel's launch: lanes a tile (the whole row when it
    fits) and its dynamic shared memory in bytes."""
    tile: int
    smem: int


def ring_layout_ints(P: int, ring: int, tile: int) -> int:
    """csrc's ``ring_layout_ints``: int32 words of the ring kernel's
    shared memory for rows of P lanes in tiles of ``tile``: the
    reduction buffers; the tile in whole int4s, and at least 2·ring
    words (the merged list reuses it); the tile's list (ring lanes and
    counts); the running list of earlier tiles when P > tile."""
    region = max(-(-tile // 4) * 4, 2 * ring)
    return RING_RED_INTS + region + 2 * ring * (2 if P > tile else 1)


def ring_geometry(P: int, ring: int) -> RingGeometry:
    """The ring kernel's tile and shared memory for rows of P lanes: the
    whole row in one tile when it fits SMEM_LIMIT, else the longest tile
    (a multiple of RING_TILE_ALIGN lanes) that fits beside both lists.
    The one place the ring's limit is decided: a ring that leaves no
    such tile raises ValueError."""
    words = SMEM_LIMIT // 4
    if ring_layout_ints(P, ring, P) <= words:
        return RingGeometry(P, 4 * ring_layout_ints(P, ring, P))
    tile = (words - RING_RED_INTS - 4 * ring) // RING_TILE_ALIGN * \
        RING_TILE_ALIGN
    if tile < max(2 * ring, RING_TILE_ALIGN):
        raise ValueError(f"nfa_bank_ring: ring {ring} leaves no tile of the "
                         f"{P} lanes in {SMEM_LIMIT} bytes of shared memory")
    return RingGeometry(tile, 4 * ring_layout_ints(P, ring, tile))


def _ring_payload(carry, count, lmt, lmk, pid):
    """The ring rows of lanes ``pid`` [CN, ring]: count, lane, captures
    and ts of the lane's last match, and ``slot_start <= ts``."""
    CN, P = (int(x) for x in count.shape)
    K = int(carry["slot_state"].shape[-1])
    caps = carry["captures"]
    caps = caps.reshape((CN, P, K) + tuple(caps.shape[-2:]))
    sel_k = lmk.gather(1, pid).long()
    n_ix = torch.arange(CN, device=count.device)[:, None]
    ring_ts = lmt.gather(1, pid)
    ring_ok = carry["slot_start"].reshape(CN, P, K)[n_ix, pid, sel_k] <= \
        ring_ts
    return (count.gather(1, pid), _i32(pid), caps[n_ix, pid, sel_k],
            ring_ts, ring_ok)


def bank_ring_model(carry: Dict[str, torch.Tensor], count: torch.Tensor,
                    lmt: torch.Tensor, lmk: torch.Tensor, ring: int,
                    tile: Optional[int] = None):
    """The CPU model of csrc/nfa_step.cu's ring kernel, with
    :func:`bank_ring_plain`'s contract.  Per pattern the row is walked in
    tiles of ``tile`` lanes (default :func:`ring_geometry`'s: the whole
    row when it fits shared memory).  Per tile: its sum (the total adds
    them modulo 2^32); k = min(ring, lanes); the k-th largest count v by
    bisection over [min, max], each step counting per warp over
    RING_WARPS contiguous ranges of int4s, the counts at the final bounds
    giving each warp its lanes above v and equal to v; the selection, each
    warp walking its range in 128-lane segments, a lane placed at its
    warp's offset plus the selected lanes before it in the segment (the
    kernel's ballots): every lane above v in lane order, then the first
    k - above lanes equal to v; the tile's list ordered (count
    descending, lane ascending) and merged with the list of the tiles
    before it (their lanes are lower: they win ties).  Then the payload
    of the ring's lanes."""
    CN, P = (int(x) for x in count.shape)
    cnt = count.cpu().numpy().astype(np.int64)
    total = (cnt.sum(axis=1) + (1 << 31)) % (1 << 32) - (1 << 31)
    total = torch.from_numpy(total.astype(np.int32)).to(count.device)
    if not ring:
        return (total,)
    tile = ring_geometry(P, ring).tile if tile is None else tile
    pid = np.empty((CN, ring), np.int64)
    for n in range(CN):
        run_pid = run_cnt = np.zeros(0, np.int64)
        for t0 in range(0, P, tile):
            x = cnt[n, t0:t0 + tile]
            nl = len(x)
            k = min(ring, nl)
            nch = -(-nl // 4)
            cpw = -(-nch // RING_WARPS)
            edges = np.array([min(nl, 4 * min(nch, w * cpw))
                              for w in range(RING_WARPS + 1)])

            def per_warp(mask):
                c = np.concatenate([[0], np.cumsum(mask)])
                return c[edges[1:]] - c[edges[:-1]]
            lo, hi = int(x.min()), int(x.max()) + 1
            g_lo, g_hi = np.diff(edges), np.zeros(RING_WARPS, np.int64)
            while hi - lo > 1:
                mid = lo + (hi - lo) // 2
                ge = per_warp(x >= mid)
                if ge.sum() >= k:
                    lo, g_lo = mid, ge
                else:
                    hi, g_hi = mid, ge
            v = lo
            above = int(g_hi.sum())
            need = k - above
            lp = np.full(k, -1, np.int64)
            lc = np.zeros(k, np.int64)
            g_eq = g_lo - g_hi
            for w in range(RING_WARPS):
                ab, eb = int(g_hi[:w].sum()), int(g_eq[:w].sum())
                a_left = int(g_hi[w])
                s = int(edges[w])
                while s < edges[w + 1] and (a_left > 0 or eb < need):
                    seg = x[s:min(s + 128, int(edges[w + 1]))]
                    lane = t0 + s + np.arange(len(seg))
                    a, q = seg > v, seg == v
                    pa = ab + np.cumsum(a) - a
                    pq = eb + np.cumsum(q) - q
                    lp[pa[a]], lc[pa[a]] = lane[a], seg[a]
                    tq = q & (pq < need)
                    lp[above + pq[tq]], lc[above + pq[tq]] = lane[tq], v
                    ab, a_left = ab + int(a.sum()), a_left - int(a.sum())
                    eb += int(q.sum())
                    s += 128
            # the tile's ranks; the running lanes with count >= c precede a
            # tile lane (a binary search in the kernel)
            ac = lc[:above]
            r_t = np.arange(k)
            r_t[:above] = (ac[None, :] > ac[:, None]).sum(axis=1) + np.tril(
                ac[None, :] == ac[:, None], -1).sum(axis=1)
            r_t += np.searchsorted(-run_cnt, -lc, side="right")
            r_r = np.arange(len(run_cnt)) + np.where(
                v > run_cnt, k - above, 0) + \
                (ac[None, :] > run_cnt[:, None]).sum(axis=1)
            n_out = min(ring, len(run_cnt) + k)
            out_pid = np.full(n_out, -1, np.int64)
            out_cnt = np.zeros(n_out, np.int64)
            for r, p_, c_ in ((r_t, lp, lc), (r_r, run_pid, run_cnt)):
                m = r < ring
                out_pid[r[m]], out_cnt[r[m]] = p_[m], c_[m]
            run_pid, run_cnt = out_pid, out_cnt
        pid[n] = run_pid
    pid = torch.from_numpy(pid).to(count.device)
    return (total,) + _ring_payload(carry, count, lmt, lmk, pid)


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
    version.  CUDA tensors launch the bank step on the current stream for
    a spec inside its class, in the instance :func:`bank_geometry` picks:
    for a widened program (:func:`kernel_wide`, its leaves lmask,
    seq_froze and telem) csrc/nfa_bank_wide.cu's widened thread instance
    (K <= 16, at most 8 constant compares, its shared memory within the
    CTA's; ``nfa_bank_step.wide_thread_launches``) or csrc/nfa_wide.cu's
    widened group instance (``nfa_bank_step.wide_launches``, with the
    flags of :func:`kernel_flags`); else csrc/nfa_step.cu's thread
    instance (the same limits; ``nfa_bank_step.thread_launches``) or
    group instance (``nfa_bank_step.group_launches``);
    ``nfa_bank_step.launches`` counts all four.  When the plain step
    would pad the block to a multiple of B (FLAG_PAD_WITHIN), both
    widened instances and the group instance with count or absent units
    run one more `within` pass at the last event's ts, and so does the
    thread instance with count units (the only thread instance where
    that pass can expire a slot).  A spec with a condition program
    launches from the build variant whose instances run programs
    (``nfa_prog``, ``nfa_bank_wide_prog``, ``nfa_wide_prog``), any other
    from ``nfa_step``, ``nfa_bank_wide`` or ``nfa_wide``.
    With ``inplace`` the new carry IS the input carry, updated in place.
    Anything else, and a failed build or launch, raises: no fallback."""
    dev = block["__ts"].device
    if dev.type == "cpu":
        return bank_lanes_plain(spec, carry, block, params, batch_b)
    reason = "no kernel program" if kprog is None else \
        bank_class_reason(spec, kprog)
    if reason is not None:
        raise RuntimeError(
            f"nfa_bank_step: spec outside the CUDA kernel's class ({reason})")
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
    _check_carry(spec, carry, lead + (P,), dev, who)
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
        k: torch.empty_like(carry[k]) for k in KERNEL_CARRY + WIDE_CARRY
        if k in carry}
    i32 = dict(dtype=torch.int32, device=dev)
    count, lmt, lmk = (torch.empty((CN, P), **i32) for _ in range(3))
    flags = kernel_flags(spec, kprog, T, batch_b)
    wide = bool(flags & FLAG_WIDE)
    geo = bank_geometry(K, T, A, R * C, sum(len(q) for q in kprog.pcmp),
                        NP, prog.numel(), count=_has(spec, "count"),
                        absent=_has(spec, "absent"), n_cond=len(kprog.cmp),
                        wide=wide,
                        wide_words=bank_wide_words(spec, K, R * C) if wide
                        else 0, n_units=len(spec.units))
    has_prog = kernel_has_prog(kprog)
    args = (
        attrs.data_ptr(), block["__ts"].data_ptr(),
        block["__stream"].data_ptr(), gates.data_ptr(), prog.data_ptr(),
        prog.numel(), ptab.data_ptr(), NP, *_carry_ptrs(carry),
        *_carry_ptrs(new), count.data_ptr(), lmt.data_ptr(), lmk.data_ptr(),
        CN, P, T, K)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pad = int((flags & FLAG_PAD_WITHIN) != 0)
    tel_w = 3 * len(spec.units) + 1 if spec.telemetry else 0
    if geo.instance == "wide_thread":
        lib = load_kernel("nfa_bank_wide_prog" if has_prog
                          else "nfa_bank_wide")
        rc = lib.nfa_bank_thread_wide(
            *args, geo.TT, A, R * C, geo.smem, geo.groups, len(kprog.cmp),
            pad, *_carry_ptrs(carry, WIDE_CARRY),
            *_carry_ptrs(new, WIDE_CARRY), tel_w, bank_wide_arrays(spec),
            len(spec.units), int(bank_first_reads(spec, kprog)), stream)
    elif geo.instance == "wide":
        lib = load_kernel("nfa_wide_prog" if has_prog else "nfa_wide")
        rc = lib.nfa_bank_step_wide(
            *args, G, A, R * C, *_carry_ptrs(carry, WIDE_CARRY),
            *_carry_ptrs(new, WIDE_CARRY), flags, tel_w, stream)
    else:
        lib = load_kernel("nfa_prog" if has_prog else "nfa_step")
        if geo.instance == "thread":
            rc = lib.nfa_bank_thread(*args, geo.TT, A, R * C, geo.smem,
                                     geo.groups, len(kprog.cmp), pad,
                                     stream)
        else:
            rc = lib.nfa_bank_step(*args, G, A, R * C, pad, stream)
    if rc != 0:
        raise RuntimeError(f"nfa_bank_step: launch failed with CUDA error "
                           f"{rc} ({geo.instance} instance)")
    nfa_bank_step.launches += 1
    if geo.instance == "wide_thread":
        nfa_bank_step.wide_thread_launches += 1
    elif geo.instance == "wide":
        nfa_bank_step.wide_launches += 1
    elif geo.instance == "thread":
        nfa_bank_step.thread_launches += 1
    else:
        nfa_bank_step.group_launches += 1
    return new, count, lmt, lmk


def nfa_bank_ring(carry: Dict[str, torch.Tensor], count: torch.Tensor,
                  lmt: torch.Tensor, lmk: torch.Tensor, ring: int):
    """The ring kernel's function, :func:`bank_ring_plain`'s contract, on
    the tensors' own device: the plain version for CPU tensors, else one
    launch of csrc/nfa_step.cu's ring kernel (one CTA per pattern, the
    row in the tiles :func:`ring_geometry` sizes; its CPU model is
    :func:`bank_ring_model`) on the current stream, or a raise."""
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
    if ring < 0 or ring > P:
        raise ValueError(f"nfa_bank_ring: ring {ring} outside [0, P = {P}]")
    geo = ring_geometry(P, ring)
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
        ring_ok.data_ptr(), CN, P, K, R * C, ring, geo.tile, geo.smem,
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


#: launches of the bank step since the last reset (plain runs excluded),
#: every instance; of them, the thread instance's (nfa_bank_thread_kernel),
#: the group instance's (csrc/nfa_step.cu's nfa_bank_step_kernel), the
#: widened group instance's (csrc/nfa_wide.cu's nfa_bank_step_kernel) and
#: the widened thread instance's (csrc/nfa_bank_wide.cu's
#: nfa_bank_wide_kernel); the ring kernel counts in
#: ``nfa_bank_ring.launches``
nfa_bank_step.launches = 0
nfa_bank_step.thread_launches = 0
nfa_bank_step.group_launches = 0
nfa_bank_step.wide_launches = 0
nfa_bank_step.wide_thread_launches = 0
