"""Device window step (K9): window state as ring slabs, one step a chunk.

Counterpart of ``siddhi_tpu/ops/dwin.py``.  The window buffer of record
lives on the device as left-aligned ring slabs (``[P, C]`` payload banks
+ timestamps + fill), and each input chunk is one step that (a) decides
every eviction / batch flush by a per-kind closed form over the pool
``[carry ring ‖ chunk]`` (searchsorted, cutoffs, batch ids, a sort order
statistic, a session's last activity) and (b) emits the affected rows as
one compacted egress buffer.  The host composes the reference's
CURRENT/EXPIRED/RESET emission order from the decoded rows
(plan/dwin_compiler.py).  The per-kind index math is the JAX module's
docstring's, kind for kind.

Two implementations of one contract:

  - :func:`dwin_step_plain` — PyTorch ops, the JAX ``build_dwin_step``
    (``:177``) line for line, vectorised over P (the ``[M, M]`` masks of
    sort and session materialised).  Used for CPU tensors and by the
    checks.
  - the hand-written Hopper kernel ``csrc/dwin_step.cu`` (P = 1, the
    compiler's shape) — launched by :func:`dwin_step` for CUDA tensors.
    It moves bits and does no float arithmetic, so it equals the plain
    version bit for bit on every egress row up to the count, the tail,
    the telemetry row and every carry leaf.  :func:`dwin_pass_model` is
    its CPU model, pass for pass.

Why the kernel is a compaction.  ``_new_ring``'s stable argsort only ever
orders live entries, whose arrival ranks rise with the pool index (carry
slot j has rank j < fill, chunk slot j has rank fill + j - C), so the new
ring is a stable partition of the pool — kept entries in index order,
then the rest in index order, cut at C — and the egress is a compaction
of the emit mask in flat order.  Both come from one exclusive scan.

Egress row schema (int32): [pool_idx, evict_t, cause, ts_off, f-bank
bitcast ×F, i-bank ×I]; tail row: [count, fill', exp_fill', min_live_ts,
overflow, 0...]; with telemetry one more row [fill gauge, evictions
total, overflow total, 0...] before the tail.  Causes: 1 = time-expired,
2 = length-displaced, 3 = batch-current, 4 = carry-expired-batch, 5 =
delayed-current.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ._kernels import load_kernel
from .grouped_agg import _check
from .windowed_agg import kernel_device

TS_NONE = 2 ** 31 - 1        # "never" / empty sentinel
C_TIME, C_LEN, C_BATCH, C_EXPBATCH, C_DELAY = 1, 2, 3, 4, 5
NEG = -(2 ** 30)             # the session kernel's "no activity" floor
BIG = 2 ** 30                # the sort kernel's "never displaced"

SLIDING_KINDS = ("length", "time", "externalTime", "timeLength", "delay")
EXP_KINDS = ("lengthBatch", "timeBatch", "externalTimeBatch", "batch",
             "hopping")
#: kind ids of csrc/dwin_step.cu's header
KIND_IDS = {k: i for i, k in enumerate(
    ("length", "time", "externalTime", "timeLength", "delay", "sort",
     "session", "hopping", "lengthBatch", "timeBatch", "externalTimeBatch",
     "batch"))}

_I32 = torch.int32


class DwinSpec(NamedTuple):
    kind: str            # length|time|externalTime|timeLength|delay|
    #                      lengthBatch|timeBatch|externalTimeBatch|batch|
    #                      sort|session|hopping
    capacity: int        # ring capacity C (grow-and-replay on overflow)
    n_f: int             # f32 payload lanes
    n_i: int             # i32 payload lanes
    window_ms: int       # time span (0 for pure length kinds); session gap
    length: int          # count bound (0 for pure time kinds)
    sort_keys: tuple = ()  # sort kind: ((bank 0=f/1=i, lane, asc), ...) —
    #                        lex compare order; LONG attrs ride two (hi,
    #                        lo) entries whose lex order IS int64 order
    skey_lane: int = -1  # session kind: i32 lane of the session key code
    telemetry: bool = False  # carry a [P, 3] telemetry leaf (fill gauge,
    #                      evictions total, overflow total) and append a
    #                      summary row before the egress tail
    hop_ms: int = 0      # hopping kind: emission period


def carry_layout(spec: DwinSpec, n_lanes: int
                 ) -> Dict[str, Tuple[torch.dtype, Tuple[int, ...], int]]:
    """{leaf: (dtype, shape, initial value)} of the carry."""
    P, W = n_lanes, spec.capacity
    F, I = max(spec.n_f, 1), max(spec.n_i, 1)
    ring = {"f": (torch.float32, (P, W, F), 0), "i": (_I32, (P, W, I), 0),
            "ts": (_I32, (P, W), TS_NONE), "fill": (_I32, (P,), 0)}
    lay = {("ring_" + k if k != "fill" else k): v for k, v in ring.items()}
    if spec.kind in EXP_KINDS:
        lay.update({"exp_" + k: v for k, v in ring.items()})
    if spec.telemetry:
        lay["telem"] = (_I32, (P, 3), 0)
    return lay


def make_dwin_carry(spec: DwinSpec, n_lanes: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """An empty carry on ``device`` (default: the card)."""
    dev = kernel_device(device)
    return {k: torch.full(shape, v, dtype=dt, device=dev)
            for k, (dt, shape, v) in carry_layout(spec, n_lanes).items()}


def egress_rows(spec: DwinSpec, cap: int) -> int:
    """Rows of one step's egress buffer: ``cap`` rows, the telemetry row,
    the tail."""
    return cap + 1 + int(spec.telemetry)


# ------------------------------------------------------------ plain version

def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap (jnp's int32 arithmetic)."""
    return (((x.long() + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(_I32)


def _wadd(a: torch.Tensor, b) -> torch.Tensor:
    return _wrap(a.long() + (b.long() if torch.is_tensor(b) else int(b)))


def searchsorted_scan(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(a, q, side='left')`` row by row, by JAX's own
    default algorithm (``method='scan'``): ceil(log2(n + 1)) halvings of
    (low, high) from (0, n), ``mid = (low + high) // 2``, ``go_left = q
    <= a[mid]``; the answer is ``high``.  On an unsorted row the answer
    depends on that exact loop.  a [P, n] int32, q [P, M] int32 → [P, M]
    int32."""
    n = a.shape[1]
    levels = int(np.ceil(np.log2(n + 1)))
    low = torch.zeros(q.shape, dtype=torch.long, device=q.device)
    high = torch.full(q.shape, n, dtype=torch.long, device=q.device)
    for _ in range(levels):
        mid = (low + high) // 2
        go_left = q <= a.gather(1, mid)
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high.to(_I32)


def _pool(carry, ev_f, ev_i, ev_ts, ev_valid, W):
    """Concat [carry ring ‖ chunk] into the stream pool [P, M]."""
    pf = torch.cat([carry["ring_f"], ev_f], dim=1)
    pi = torch.cat([carry["ring_i"], ev_i], dim=1)
    none = torch.full_like(ev_ts, TS_NONE)
    pts = torch.cat([carry["ring_ts"], torch.where(ev_valid, ev_ts, none)],
                    dim=1)
    P, M = pts.shape
    j = torch.arange(M, device=pts.device)[None, :]
    fill = carry["fill"].long()[:, None]
    nv = ev_valid.sum(dim=1)[:, None]
    live = torch.where(j < W, j < fill, j - W < nv)
    rank = torch.where(j < W, j, fill + (j - W))
    return pf, pi, pts, live, rank, nv[:, 0]


def _new_ring(pf, pi, pts, keep, rank, W):
    """Left-align surviving entries into a fresh [P, W] ring (a stable
    argsort by arrival rank, the JAX package's)."""
    P, M = pts.shape
    key = torch.where(keep, rank, torch.full_like(rank, M + 1))
    order = torch.argsort(key, dim=1, stable=True)
    sf = pf.gather(1, order[:, :, None].expand(-1, -1, pf.shape[2]))[:, :W]
    si = pi.gather(1, order[:, :, None].expand(-1, -1, pi.shape[2]))[:, :W]
    sts = torch.where(keep, pts, torch.full_like(pts, TS_NONE)) \
        .gather(1, order)[:, :W]
    fill = keep.sum(dim=1)
    overflow = fill > W
    slot = torch.arange(W, device=pts.device)[None, :]
    sts = torch.where(slot < fill[:, None], sts, torch.full_like(sts,
                                                                 TS_NONE))
    return sf, si, sts, torch.clamp(fill, max=W).to(_I32), overflow


def _pack_egress(emit_mask, evict_t, cause, pts, pf, pi, tail_vals, cap,
                 telem_row=None):
    """[P, M] emission set → [cap+1, 4+F+I] compacted rows + tail (the
    JAX ``_pack_egress``, padding rows included: ``pool_idx`` -1 and
    element 0's other columns).  A telemetry row goes before the tail."""
    F, I = pf.shape[-1], pi.shape[-1]
    dev = pts.device
    flat = emit_mask.reshape(-1)
    (hit,) = torch.nonzero(flat, as_tuple=True)
    idx = torch.full((cap,), -1, dtype=torch.long, device=dev)
    n = min(hit.numel(), cap)
    idx[:n] = hit[:n]
    safe = torch.clamp(idx, min=0)

    def g(a):
        return a.reshape(-1)[safe][:, None].to(_I32)
    f_bits = pf.reshape(-1, F).contiguous().view(_I32)[safe]
    i_vals = pi.reshape(-1, I)[safe]
    rows = torch.cat([idx[:, None].to(_I32), g(evict_t), g(cause), g(pts),
                      f_bits, i_vals], dim=1)
    tail = torch.zeros((1, 4 + F + I), dtype=_I32, device=dev)
    tail[0, 0] = flat.sum()
    for k, v in enumerate(tail_vals):
        tail[0, 1 + k] = v
    parts = [rows]
    if telem_row is not None:
        trow = torch.zeros((1, 4 + F + I), dtype=_I32, device=dev)
        trow[0, :3] = telem_row
        parts.append(trow)
    parts.append(tail)
    return torch.cat(parts, dim=0)


def _full(shape, v, dev):
    return torch.full(shape, v, dtype=_I32, device=dev)


def dwin_step_plain(spec: DwinSpec, carry: Dict[str, torch.Tensor],
                    ev_f: torch.Tensor, ev_i: torch.Tensor,
                    ev_ts: torch.Tensor, ev_valid: torch.Tensor,
                    now: torch.Tensor, directive: torch.Tensor, cap: int
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One step in plain PyTorch: ``(carry, ev_f [P,T,F] f32, ev_i
    [P,T,I] i32, ev_ts [P,T] i32, ev_valid [P,T] bool, now [P] i32,
    directive [P,T] i32, cap) → (new carry, egress [cap+1(+1), 4+F+I]
    i32)``.  ``now`` and ``directive`` are the kind's host control input
    (the batch kinds: flushes done and each row's flush id; hopping:
    ``directive[:, 0] > 0`` marks a flush step).  Functional."""
    W = spec.capacity
    kind = spec.kind
    pf, pi, pts, live, rank, nv = _pool(carry, ev_f, ev_i, ev_ts, ev_valid,
                                        W)
    P, M = pts.shape
    dev = pts.device
    fill = carry["fill"].long()
    j = torch.arange(M, device=dev)[None, :]
    is_carry = j < W
    new_carry = dict(carry)
    now = now.to(_I32)

    def telem(nfill, emit_mask, ovf_mask):
        tel = carry.get("telem")
        if tel is None:
            return None
        ev = emit_mask.sum(dim=1)
        nt = torch.stack([nfill.long(), tel[:, 1].long() + ev,
                          tel[:, 2].long() + ovf_mask.long()], dim=1)
        nt = _wrap(nt)
        new_carry["telem"] = nt
        return torch.stack([nt[:, 0].max(), _wrap(nt[:, 1].long().sum()),
                            _wrap(nt[:, 2].long().sum())])

    def ring_update(sf, si, sts, nfill):
        new_carry.update(ring_f=sf, ring_i=si, ring_ts=sts, fill=nfill)

    if kind == "sort":
        n = spec.length
        less = torch.zeros((P, M, M), dtype=torch.bool, device=dev)
        eq = torch.ones((P, M, M), dtype=torch.bool, device=dev)
        for (bank, lane, asc) in spec.sort_keys:
            v = pf[:, :, lane] if bank == 0 else pi[:, :, lane]
            a = v[:, :, None]           # x
            b = v[:, None, :]           # y
            lt = (b < a) if asc else (b > a)
            less = less | (eq & lt)
            eq = eq & (b == a)
        # tie: the NEWEST (largest rank) is evicted first
        less = less | (eq & (rank[:, None, :] < rank[:, :, None]))
        less = less & live[:, None, :]
        arr = torch.where(is_carry, torch.full_like(rank, -1),
                          rank - fill[:, None])
        a_mask = torch.where(less, arr[:, None, :],
                             torch.full_like(less, BIG, dtype=torch.long))
        a_sorted = torch.sort(a_mask, dim=2).values
        idx = min(n - 1, M - 1)
        tN = a_sorted[:, :, idx]
        evict_t = torch.maximum(tN, arr)
        if n - 1 < M:
            evicted = live & (tN < BIG) & (evict_t < nv[:, None])
        else:
            evicted = torch.zeros((P, M), dtype=torch.bool, device=dev)
        cause = _full((P, M), C_LEN, dev)
        keep = live & ~evicted
        sf, si, sts, nfill, ovf = _new_ring(pf, pi, pts, keep, rank, W)
        ring_update(sf, si, sts, nfill)
        buf = _pack_egress(evicted, evict_t, cause, pts, pf, pi,
                           (nfill.max(), 0, TS_NONE, ovf.int().max()), cap,
                           telem_row=telem(nfill, evicted, ovf))
        return new_carry, buf

    if kind == "session":
        key = pi[:, :, spec.skey_lane]
        carry_live = live & is_carry
        same = (key[:, None, :] == key[:, :, None]) & carry_live[:, None, :]
        last = torch.where(same, pts[:, None, :],
                           torch.full_like(same, NEG, dtype=_I32)).amax(2)
        evict_ts = _wadd(last, spec.window_ms)
        expired = carry_live & (evict_ts <= now[:, None])
        cause = _full((P, M), C_TIME, dev)
        keep = live & ~expired
        sf, si, sts, nfill, ovf = _new_ring(pf, pi, pts, keep, rank, W)
        ring_update(sf, si, sts, nfill)
        # the host re-arms its gap timer at (min over live entries of
        # their KEY's last activity) + gap
        w_live = torch.arange(W, device=dev)[None, :] < nfill[:, None]
        k_new = si[:, :, spec.skey_lane]
        same_new = (k_new[:, None, :] == k_new[:, :, None]) & \
            w_live[:, None, :]
        last_new = torch.where(same_new, sts[:, None, :],
                               torch.full_like(same_new, NEG,
                                               dtype=_I32)).amax(2)
        live_min = torch.where(w_live, last_new,
                               torch.full_like(last_new, TS_NONE)).min()
        buf = _pack_egress(expired, evict_ts, cause, pts, pf, pi,
                           (nfill.max(), 0, live_min, ovf.int().max()), cap,
                           telem_row=telem(nfill, expired, ovf))
        return new_carry, buf

    if kind in SLIDING_KINDS:
        if kind == "length":
            evict_t = _wrap(rank + spec.length - fill[:, None])
            evicted = live & (evict_t < nv[:, None]) & (evict_t >= 0)
            cause = _full((P, M), C_LEN, dev)
        elif kind in ("time", "delay"):
            cutoff = _wadd(now, -spec.window_ms)[:, None]
            evicted = live & is_carry & (pts <= cutoff)
            evict_t = _full((P, M), 0, dev)
            cause = _full((P, M), C_TIME if kind == "time" else C_DELAY,
                          dev)
        else:
            ets = torch.where(ev_valid, ev_ts, torch.full_like(ev_ts,
                                                               TS_NONE))
            t_evict = searchsorted_scan(ets, _wadd(pts, spec.window_ms))
            after_self = torch.clamp(rank - fill[:, None] + 1, min=0)
            t_evict = torch.maximum(t_evict.long(), after_self)
            if kind == "externalTime":
                evict_t = t_evict
                evicted = live & (evict_t < nv[:, None])
                cause = _full((P, M), C_TIME, dev)
            else:                                    # timeLength
                l_evict = torch.maximum(
                    _wrap(rank + spec.length - fill[:, None]).long(),
                    after_self)
                evict_t = torch.minimum(t_evict, l_evict)
                by_now = (nv[:, None] == 0) & \
                    (_wadd(pts, spec.window_ms) <= now[:, None])
                evicted = live & ((evict_t < nv[:, None]) | by_now)
                cause = torch.where(t_evict <= l_evict, C_TIME,
                                    C_LEN).to(_I32)
        keep = live & ~evicted
        sf, si, sts, nfill, ovf = _new_ring(pf, pi, pts, keep, rank, W)
        ring_update(sf, si, sts, nfill)
        slot = torch.arange(W, device=dev)[None, :]
        live_min = torch.where(slot < nfill[:, None], sts,
                               torch.full_like(sts, TS_NONE)).min()
        buf = _pack_egress(evicted, evict_t, cause, pts, pf, pi,
                           (nfill.max(), 0, live_min, ovf.int().max()), cap,
                           telem_row=telem(nfill, evicted, ovf))
        return new_carry, buf

    eslot = torch.arange(W, device=dev)[None, :]
    exp_cause = _full((P, W), C_EXPBATCH, dev)

    def exp_pack(emit_pool, exp_emit, pool_t, cause, tail_vals, ovf_mask,
                 nfill):
        all_mask = torch.cat([emit_pool, exp_emit], dim=1)
        all_t = torch.cat([pool_t, _full((P, W), 0, dev)], dim=1)
        all_cause = torch.cat([cause, exp_cause], dim=1)
        all_ts = torch.cat([pts, carry["exp_ts"]], dim=1)
        all_f = torch.cat([pf, carry["exp_f"]], dim=1)
        all_i = torch.cat([pi, carry["exp_i"]], dim=1)
        return _pack_egress(all_mask, all_t, all_cause, all_ts, all_f,
                            all_i, tail_vals, cap,
                            telem_row=telem(nfill, all_mask, ovf_mask))

    if kind == "hopping":
        flushing = directive[:, 0] > 0
        cutoff = _wadd(now, -spec.window_ms)[:, None]
        keep = live & (~flushing[:, None] | (pts > cutoff))
        sf, si, sts, nfill, ovf = _new_ring(pf, pi, pts, keep, rank, W)
        cur_emit = keep & flushing[:, None]
        exp_emit = (eslot < carry["exp_fill"][:, None]) & \
            flushing[:, None] & (carry["exp_ts"] <= cutoff)
        post_exp_fill = torch.where(flushing, nfill, carry["exp_fill"])
        buf = exp_pack(cur_emit, exp_emit, _full((P, M), 0, dev),
                       _full((P, M), C_BATCH, dev),
                       (nfill.max(), post_exp_fill.max(), TS_NONE,
                        ovf.int().max()), ovf, nfill)
        ring_update(sf, si, sts, nfill)
        fl3 = flushing[:, None, None]
        new_carry.update(
            exp_f=torch.where(fl3, sf, carry["exp_f"]),
            exp_i=torch.where(fl3, si, carry["exp_i"]),
            exp_ts=torch.where(flushing[:, None], sts, carry["exp_ts"]),
            exp_fill=post_exp_fill)
        return new_carry, buf

    if kind == "batch":
        # the whole chunk replaces the ring; the previous ring emits as
        # the expired batch (the exp planes pass through untouched)
        has_ev = (nv > 0)[:, None]
        emit = live & ((is_carry & has_ev) | ~is_carry)
        cause = torch.where(is_carry, C_EXPBATCH, C_BATCH).to(_I32)
        keep = live & (~is_carry | (is_carry & ~has_ev))
        sf, si, sts, nfill, ovf = _new_ring(pf, pi, pts, keep, rank, W)
        ring_update(sf, si, sts, nfill)
        buf = _pack_egress(emit, _full((P, M), 0, dev), cause, pts, pf, pi,
                           (nfill.max(), 0, TS_NONE, ovf.int().max()), cap,
                           telem_row=telem(nfill, emit, ovf))
        return new_carry, buf

    # lengthBatch / timeBatch / externalTimeBatch: `directive` holds each
    # chunk row's flush id, `now` the flushes completed this step
    if kind == "lengthBatch":
        n = spec.length
        batch_id = rank // n
        n_done = (fill + nv) // n
        flushed = live & (batch_id < n_done[:, None])
        last_id = n_done - 1
    else:
        batch_id = torch.cat([torch.zeros((P, W), dtype=torch.long,
                                          device=dev), directive.long()],
                             dim=1)
        n_done = now.long()
        flushed = live & (batch_id < n_done[:, None])
        if kind == "timeBatch":
            last_id = n_done - 1
        else:
            # expired_batch is only replaced by a NON-EMPTY batch
            last_id = torch.where(flushed, batch_id,
                                  torch.full_like(batch_id, -1)).amax(1)
    keep = live & ~flushed
    in_last = flushed & (batch_id == last_id[:, None]) & \
        (last_id >= 0)[:, None]
    sf, si, sts, nfill, ovf = _new_ring(pf, pi, pts, keep, rank, W)
    ef, ei, ets_, efill, eovf = _new_ring(pf, pi, pts, in_last, rank, W)
    any_flush = n_done > 0
    post_exp_fill = torch.where(any_flush, efill, carry["exp_fill"])
    exp_emit = (eslot < carry["exp_fill"][:, None]) & any_flush[:, None]
    buf = exp_pack(flushed, exp_emit, _wrap(batch_id),
                   _full((P, M), C_BATCH, dev),
                   (nfill.max(), post_exp_fill.max(), TS_NONE,
                    (ovf | eovf).int().max()), ovf | eovf, nfill)
    ring_update(sf, si, sts, nfill)
    af3 = any_flush[:, None, None]
    new_carry.update(
        exp_f=torch.where(af3, ef, carry["exp_f"]),
        exp_i=torch.where(af3, ei, carry["exp_i"]),
        exp_ts=torch.where(any_flush[:, None], ets_, carry["exp_ts"]),
        exp_fill=post_exp_fill.to(_I32))
    return new_carry, buf


# ------------------------------------------------------------------ kernel

#: carry leaves in csrc/dwin_step.cu's pointer order (absent leaves: null)
CARRY_KEYS = ("ring_f", "ring_i", "ring_ts", "fill", "exp_f", "exp_i",
              "exp_ts", "exp_fill", "telem")
MAX_SORT_KEYS = 16


def kernel_header(spec: DwinSpec, T: int, cap: int) -> list:
    """csrc/dwin_step.cu's header ints for one step."""
    if len(spec.sort_keys) > MAX_SORT_KEYS:
        raise ValueError(f"dwin_step: at most {MAX_SORT_KEYS} sort keys")
    h = [KIND_IDS[spec.kind], spec.capacity, T, max(spec.n_f, 1),
         max(spec.n_i, 1), int(spec.window_ms), int(spec.length),
         int(spec.skey_lane), int(spec.telemetry), int(spec.hop_ms), cap,
         len(spec.sort_keys)]
    for bank, lane, asc in spec.sort_keys:
        h += [int(bank), int(lane), int(bool(asc))]
    return h


def dwin_launch(lib, spec: DwinSpec, carry, ev_f, ev_i, ev_ts, ev_valid,
                now, directive, cap: int, stream):
    """Allocate the fresh carry, the egress buffer and the scratch on the
    inputs' device and call ``lib.dwin_step`` (the loaded kernel) on
    ``stream``; raises on a non-zero CUDA error."""
    import ctypes
    T = ev_ts.shape[1]
    dev = ev_ts.device
    F, I = max(spec.n_f, 1), max(spec.n_i, 1)
    hdr_list = kernel_header(spec, T, cap)
    hdr = (ctypes.c_int * len(hdr_list))(*hdr_list)
    nscratch = int(lib.dwin_scratch_bytes(hdr))
    scratch = torch.empty((nscratch,), dtype=torch.uint8, device=dev)
    new = {k: torch.empty_like(v) for k, v in carry.items()}
    buf = torch.empty((egress_rows(spec, cap), 4 + F + I), dtype=_I32,
                      device=dev)
    tensors = ([carry.get(k) for k in CARRY_KEYS] +
               [ev_f, ev_i, ev_ts, ev_valid, now, directive] +
               [new.get(k) for k in CARRY_KEYS] + [buf, scratch])
    ptrs = [t.data_ptr() if t is not None else 0 for t in tensors]
    arr = (ctypes.c_longlong * len(ptrs))(*ptrs)
    rc = lib.dwin_step(hdr, arr, nscratch, stream)
    if rc != 0:
        raise RuntimeError(f"dwin_step: launch failed with CUDA error {rc}")
    return new, buf


def dwin_step(spec: DwinSpec, carry: Dict[str, torch.Tensor],
              ev_f: torch.Tensor, ev_i: torch.Tensor, ev_ts: torch.Tensor,
              ev_valid: torch.Tensor, now: torch.Tensor,
              directive: torch.Tensor, cap: int
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The step on the tensors' own device.

    CPU tensors run :func:`dwin_step_plain`.  CUDA tensors launch
    ``csrc/dwin_step.cu`` (four launches on the current stream) for one
    lane (P = 1), writing a FRESH carry: the caller keeps the carry it
    passed in and replays from it when the tail reports an overflow.
    The egress rows past the count are not written.  A failed build,
    load or launch raises — there is no fallback to the plain version."""
    dev = ev_ts.device
    if dev.type == "cpu":
        return dwin_step_plain(spec, carry, ev_f, ev_i, ev_ts, ev_valid,
                               now, directive, cap)
    if dev.type != "cuda":
        raise RuntimeError(f"dwin_step: no kernel for device {dev}")
    C = spec.capacity
    F, I = max(spec.n_f, 1), max(spec.n_i, 1)
    T = ev_ts.shape[1] if ev_ts.dim() == 2 else -1
    if T < 1:
        raise ValueError("dwin_step: a step needs T >= 1")
    want = carry_layout(spec, 1)
    if set(carry) != set(want):
        raise ValueError(f"dwin_step: carry leaves {sorted(carry)}, "
                         f"expected {sorted(want)}")
    fn = "dwin_step"
    for k, (dt, shape, _) in want.items():
        _check(fn, k, carry[k], dt, shape, dev)
    _check(fn, "ev_f", ev_f, torch.float32, (1, T, F), dev)
    _check(fn, "ev_i", ev_i, _I32, (1, T, I), dev)
    _check(fn, "ev_ts", ev_ts, _I32, (1, T), dev)
    _check(fn, "ev_valid", ev_valid, torch.bool, (1, T), dev)
    _check(fn, "now", now, _I32, (1,), dev)
    _check(fn, "directive", directive, _I32, (1, T), dev)
    new, buf = dwin_launch(load_kernel("dwin_step"), spec, carry, ev_f,
                           ev_i, ev_ts, ev_valid, now, directive, cap,
                           torch.cuda.current_stream(dev).cuda_stream)
    dwin_step.launches += 1
    return new, buf


#: launches of the CUDA kernel since the last reset (plain runs excluded)
dwin_step.launches = 0


# --------------------------------------------------------------- CPU model

#: bits of a radix digit of the sort and session passes (kDigitBits)
DIGIT_BITS = 4


def order_keys(bits: np.ndarray, bank: int, asc: bool) -> np.ndarray:
    """csrc/dwin_step.cu okey over a lane's 32-bit words (float bits for
    bank 0): uint32 keys whose order is the sort key's direction, -0.0
    as +0.0 and NaN after every number either way."""
    u = np.asarray(bits).astype(np.int64) & 0xFFFFFFFF
    if bank == 0:
        nan = (u & 0x7FFFFFFF) > 0x7F800000
        u = np.where(u == 0x80000000, 0, u)
        a = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    else:
        nan = np.zeros(u.shape, bool)
        a = u ^ 0x80000000
    a = a if asc else ~a & 0xFFFFFFFF
    return np.where(nan, 0xFFFFFFFF, a)


def radix_pass(seq: np.ndarray, digit: np.ndarray, bins: int, block: int):
    """One stable partition pass of the kernel's radix sort (count, scan,
    scatter): per block of ``block`` items its digit counts, offsets
    digit-major (all blocks' digit 0, then digit 1, ...), each item at
    its digit's base + its block's offset + its stable rank in the block.
    Returns (the new sequence, each item's rank in its block, each
    block's offset of digit 0)."""
    L = len(seq)
    blk = np.arange(L) // block
    nb = max(-(-L // block), 1)
    counts = np.zeros((bins, nb), np.int64)
    np.add.at(counts, (digit, blk), 1)
    comb = blk * bins + digit
    order = np.argsort(comb, kind="stable")
    first = np.searchsorted(comb[order], comb[order], side="left")
    rank = np.empty(L, np.int64)
    rank[order] = np.arange(L) - first
    flat = counts.reshape(-1)
    off = (np.cumsum(flat) - flat).reshape(bins, nb)    # digit-major
    out = np.empty_like(seq)
    out[off[digit, blk] + rank] = seq
    return out, rank, off[0]


def radix_sort_model(keys, L: int, block: int) -> np.ndarray:
    """The kernel's LSD radix sort of the ranks 0..L-1 by ``keys`` (uint32
    arrays over the ranks, in lex order): DIGIT_BITS-bit digits, the last
    key's lowest digit first."""
    seq = np.arange(L, dtype=np.int64)
    bins = 1 << DIGIT_BITS
    for k in reversed(keys):
        for sh in range(0, 32, DIGIT_BITS):
            seq = radix_pass(seq, (k[seq] >> sh) & (bins - 1), bins,
                             block)[0]
    return seq


def wavelet_model(seq: np.ndarray, nbits: int, block: int):
    """The kernel's wavelet matrix over ``seq``: per level (high bit
    first) a stable 1-bit radix pass; R[l][i] the level's zeros before
    position i (its block's digit-0 offset + the zeros before it in the
    block), R[l][L] and Z[l] the level's zeros."""
    L = len(seq)
    R = np.zeros((nbits, L + 1), np.int64)
    Z = np.zeros(nbits, np.int64)
    pos = np.arange(L)
    for lv in range(nbits):
        d = (seq >> (nbits - 1 - lv)) & 1
        nxt, rank, off0 = radix_pass(seq, d, 2, block)
        inb = pos % block
        R[lv, :L] = off0[pos // block] + np.where(d == 0, rank, inb - rank)
        Z[lv] = R[lv, L] = int((d == 0).sum())
        seq = nxt
    return R, Z


def wavelet_kth(R, Z, nbits: int, k: int, length: int) -> int:
    """The k-th smallest (from 0) of the wavelet's sequence in [0,
    length): one rank lookup pair a level."""
    lo, hi, v = 0, length, 0
    for lv in range(nbits):
        rlo, rhi = int(R[lv, lo]), int(R[lv, hi])
        if k < rhi - rlo:
            lo, hi = rlo, rhi
        else:
            k -= rhi - rlo
            lo, hi = int(Z[lv]) + lo - rlo, int(Z[lv]) + hi - rhi
            v |= 1 << (nbits - 1 - lv)
    return v


def sort_prefix_lengths(okeys, nan_first, srt) -> np.ndarray:
    """Per rank, the length of its lex-predecessor prefix of the sorted
    order ``srt``: its sorted position, or, when its first NaN key is k
    (``nan_first``, -1 for none), the start of the run sharing its first
    k order keys (a binary search, the kernel's)."""
    out = np.empty(len(srt), np.int64)
    for i, r in enumerate(srt):
        k = int(nan_first[r])
        if k < 0:
            out[r] = i
            continue
        xk = tuple(int(okeys[j][r]) for j in range(k))
        lo, hi = 0, i
        while lo < hi:
            mid = (lo + hi) >> 1
            if tuple(int(okeys[j][srt[mid]]) for j in range(k)) < xk:
                lo = mid + 1
            else:
                hi = mid
        out[r] = lo
    return out


def dwin_pass_model(spec: DwinSpec, carry: Dict[str, np.ndarray], ev_f,
                    ev_i, ev_ts, ev_valid, now, directive, cap: int,
                    block: int = 256):
    """csrc/dwin_step.cu's passes in numpy, at P = 1 (numpy in, numpy out,
    the egress rows past the count left zero): prep (nv, the last flushed
    batch id); for sort and session the radix sort of the live entries
    (:func:`radix_sort_model`), then sort's prefix lengths and wavelet
    matrix (:func:`sort_prefix_lengths`, :func:`wavelet_model`) or
    session's runs and their carried maxima; decide (one entry at a
    time, the kernel's per-thread code: JAX's scan searchsorted, sort's
    wavelet descent); in-block ranks, the scan of block counts, session's
    new-ring maxima and counts, and the scatter by partition and emit
    positions, with the tail written last.  ``block`` is the CTA's
    entries (the kernel's kB).  The tests hold it against
    :func:`dwin_step_plain`."""
    def wrap(v):
        return int(((int(v) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31))

    kind, C = spec.kind, spec.capacity
    F, I = max(spec.n_f, 1), max(spec.n_i, 1)
    T = ev_ts.shape[1]
    M = C + T
    emits_exp = kind in ("hopping", "lengthBatch", "timeBatch",
                         "externalTimeBatch")
    M2 = M + (C if emits_exp else 0)
    fill = int(carry["fill"][0])
    nowv = int(np.asarray(now).reshape(-1)[0])
    dirv = np.asarray(directive).reshape(-1)
    valid = np.asarray(ev_valid).reshape(-1)
    ring_f = carry["ring_f"][0].view(np.int32)
    ring_i = carry["ring_i"][0]
    evf = np.asarray(ev_f)[0].view(np.int32)
    evi = np.asarray(ev_i)[0]
    evts = np.asarray(ev_ts).reshape(-1)

    def pts(x):
        if x < C:
            return int(carry["ring_ts"][0, x])
        return int(evts[x - C]) if valid[x - C] else TS_NONE

    def pf(x):
        return ring_f[x] if x < C else evf[x - C]

    def pi(x):
        return ring_i[x] if x < C else evi[x - C]

    # pass 0
    nv = int(valid.sum())
    last_id = -1
    if kind == "externalTimeBatch":
        last_id = 0 if fill > 0 and nowv > 0 else -1
        for t in range(min(nv, T)):
            if dirv[t] < nowv:
                last_id = max(last_id, int(dirv[t]))

    # sort and session: the live entries (ranks 0..L-1) in key order
    L = fill + nv

    def pool_of(r):
        return r if r < fill else C + (r - fill)
    if kind in ("sort", "session"):
        xs = [pool_of(r) for r in range(L)]
        keys = (spec.sort_keys if kind == "sort"
                else ((1, spec.skey_lane, True),))
        okeys = [order_keys(np.asarray(
            [pf(x)[lane] if bank == 0 else pi(x)[lane] for x in xs],
            np.int32), bank, asc) for bank, lane, asc in keys]
        srt = radix_sort_model(okeys or [np.zeros(L, np.int64)], L, block)
        if kind == "sort":
            nan_first = np.full(L, -1, np.int64)
            for k in reversed(range(len(keys))):
                if keys[k][0] == 0:
                    nan_first[okeys[k] == 0xFFFFFFFF] = k
            plen = sort_prefix_lengths(okeys, nan_first, srt)
            nbits = max((M - 1).bit_length(), 1)
            wr, wz = wavelet_model(srt, nbits, block)
        else:
            skey = np.asarray([int(pi(x)[spec.skey_lane]) for x in xs],
                              np.int64)
            inv = np.empty(L, np.int64)
            inv[srt] = np.arange(L)
            runs = np.searchsorted(skey[srt], skey[srt], side="left")
            mxa = np.full(L, NEG, np.int64)
            carried = srt < fill
            np.maximum.at(mxa, runs[carried],
                          [pts(pool_of(r)) for r in srt[carried]])

    def search(v):
        levels = 0
        while (1 << levels) < T + 1:
            levels += 1
        low, high = 0, T
        for _ in range(levels):
            mid = (low + high) >> 1
            a = int(evts[mid]) if valid[mid] else TS_NONE
            if v <= a:
                high = mid
            else:
                low = mid
        return high

    # pass 1
    keep = np.zeros(M2, bool)
    emit = np.zeros(M2, bool)
    xkeep = np.zeros(M2, bool)
    evt = np.zeros(M2, np.int64)
    cause = np.zeros(M2, np.int64)
    w = spec.window_ms
    for x in range(M2):
        if x >= M:
            e = x - M
            if kind == "hopping":
                emit[x] = e < int(carry["exp_fill"][0]) and dirv[0] > 0 and \
                    int(carry["exp_ts"][0, e]) <= wrap(nowv - w)
            else:
                nd = (fill + nv) // spec.length if kind == "lengthBatch" \
                    else nowv
                emit[x] = e < int(carry["exp_fill"][0]) and nd > 0
            cause[x] = C_EXPBATCH
            continue
        is_carry = x < C
        live = x < fill if is_carry else (x - C) < nv
        rank = x if is_carry else fill + (x - C)
        after_self = max(x - fill + 1, 0) if is_carry else x - C + 1
        p = pts(x)
        if kind == "sort":
            n = spec.length
            tN = BIG
            if live and 1 <= n and n - 1 < M and plen[rank] >= n:
                v = wavelet_kth(wr, wz, nbits, n - 1, int(plen[rank]))
                tN = -1 if v < fill else v - fill
            arr = -1 if is_carry else x - C
            evt[x] = max(tN, arr)
            emit[x] = live and n - 1 < M and tN < BIG and evt[x] < nv
            keep[x] = live and not emit[x]
            cause[x] = C_LEN
        elif kind == "session":
            last = int(mxa[runs[inv[x]]]) if is_carry and live else NEG
            evt[x] = wrap(last + w)
            emit[x] = is_carry and live and evt[x] <= nowv
            keep[x] = live and not emit[x]
            cause[x] = C_TIME
        elif kind == "length":
            evt[x] = wrap(rank + spec.length - fill)
            emit[x] = live and 0 <= evt[x] < nv
            keep[x] = live and not emit[x]
            cause[x] = C_LEN
        elif kind in ("time", "delay"):
            emit[x] = live and is_carry and p <= wrap(nowv - w)
            keep[x] = live and not emit[x]
            cause[x] = C_TIME if kind == "time" else C_DELAY
        elif kind in ("externalTime", "timeLength"):
            te = max(search(wrap(p + w)), after_self)
            if kind == "externalTime":
                evt[x] = te
                emit[x] = live and te < nv
                cause[x] = C_TIME
            else:
                le = max(wrap(rank + spec.length - fill), after_self)
                evt[x] = min(te, le)
                by_now = nv == 0 and wrap(p + w) <= nowv
                emit[x] = live and (evt[x] < nv or by_now)
                cause[x] = C_TIME if te <= le else C_LEN
            keep[x] = live and not emit[x]
        elif kind == "hopping":
            fl = dirv[0] > 0
            keep[x] = live and (not fl or p > wrap(nowv - w))
            emit[x] = keep[x] and fl
            cause[x] = C_BATCH
        elif kind == "batch":
            has_ev = nv > 0
            emit[x] = live and ((is_carry and has_ev) or not is_carry)
            keep[x] = live and (not is_carry or not has_ev)
            cause[x] = C_EXPBATCH if is_carry else C_BATCH
        else:
            if kind == "lengthBatch":
                bid = rank // spec.length
                nd = (fill + nv) // spec.length
                lid = nd - 1
            else:
                bid = 0 if is_carry else int(dirv[x - C])
                nd = nowv
                lid = nd - 1 if kind == "timeBatch" else last_id
            emit[x] = live and bid < nd
            keep[x] = live and not emit[x]
            xkeep[x] = emit[x] and bid == lid and lid >= 0
            evt[x] = bid
            cause[x] = C_BATCH
    nb = -(-M2 // block)

    def ranks(flag):
        r = np.zeros(M2, np.int64)
        counts = np.zeros(nb, np.int64)
        for b in range(nb):
            sl = slice(b * block, min((b + 1) * block, M2))
            f = flag[sl].astype(np.int64)
            r[sl] = np.cumsum(f) - f
            counts[b] = f.sum()
        return r, counts
    kr, kc = ranks(keep)
    er, ec = ranks(emit)
    xr, xc = ranks(xkeep)
    # pass 2
    ko, eo, xo = (np.cumsum(c) - c for c in (kc, ec, xc))
    K, E, X = int(kc.sum()), int(ec.sum()), int(xc.sum())
    # pass 3
    out = {k: np.array(v, copy=True) for k, v in carry.items()}
    o_rf = out["ring_f"][0].view(np.int32)
    o_ri = out["ring_i"][0]
    o_rts = out["ring_ts"][0]
    exp_new = False
    if kind == "hopping":
        exp_new = dirv[0] > 0
    elif kind == "lengthBatch":
        exp_new = (fill + nv) // spec.length > 0
    elif kind in ("timeBatch", "externalTimeBatch"):
        exp_new = nowv > 0
    buf = np.zeros((egress_rows(spec, cap), 4 + F + I), np.int32)
    kp = np.full(M, C, np.int64)
    for x in range(M):
        kb = ko[x // block] + kr[x]
        kp[x] = kb if keep[x] else K + (x - kb)
        if kp[x] < C:
            ts = pts(x) if keep[x] else TS_NONE
            o_rf[kp[x]], o_ri[kp[x]], o_rts[kp[x]] = pf(x), pi(x), ts
            if kind == "hopping" and exp_new:
                out["exp_f"][0].view(np.int32)[kp[x]] = pf(x)
                out["exp_i"][0][kp[x]] = pi(x)
                out["exp_ts"][0][kp[x]] = ts
        if exp_new and kind != "hopping":
            xb = xo[x // block] + xr[x]
            xp = xb if xkeep[x] else X + (x - xb)
            if xp < C:
                out["exp_f"][0].view(np.int32)[xp] = pf(x)
                out["exp_i"][0][xp] = pi(x)
                out["exp_ts"][0][xp] = pts(x) if xkeep[x] else TS_NONE
    for x in range(M2):
        if not emit[x]:
            continue
        r = eo[x // block] + er[x]
        if r >= cap:
            continue
        if x < M:
            ts, f, i = pts(x), pf(x), pi(x)
        else:
            e = x - M
            ts = int(carry["exp_ts"][0, e])
            f = carry["exp_f"][0, e].view(np.int32)
            i = carry["exp_i"][0, e]
        buf[r, :4] = (x, wrap(evt[x]), cause[x], ts)
        buf[r, 4:4 + F] = f
        buf[r, 4 + F:] = i
    live_min = TS_NONE
    mine = [x for x in range(M) if keep[x] and kp[x] < C]
    if kind in SLIDING_KINDS:
        live_min = min([pts(x) for x in mine], default=TS_NONE)
    elif kind == "session":
        # the runs' max ts and count over the new ring's entries
        mxb = np.full(L, np.iinfo(np.int32).min, np.int64)
        cb = np.zeros(L, np.int64)
        for x in mine:
            rs = runs[inv[x if x < C else fill + (x - C)]]
            mxb[rs] = max(mxb[rs], pts(x))
            cb[rs] += 1
        for x in mine:
            rs = runs[inv[x if x < C else fill + (x - C)]]
            last = int(mxb[rs])
            live_min = min(live_min,
                           last if cb[rs] >= C or last > NEG else NEG)
    nfill = min(K, C)
    ovf = int(K > C)
    post_exp = 0
    if kind == "hopping":
        post_exp = nfill if exp_new else int(carry["exp_fill"][0])
    elif kind in ("lengthBatch", "timeBatch", "externalTimeBatch"):
        post_exp = min(X, C) if exp_new else int(carry["exp_fill"][0])
        ovf = int(ovf or X > C)
    out["fill"][0] = nfill
    if kind in EXP_KINDS and kind != "batch":
        out["exp_fill"][0] = post_exp
    if spec.telemetry:
        tel = carry["telem"][0]
        nt = [nfill, wrap(int(tel[1]) + E), wrap(int(tel[2]) + ovf)]
        out["telem"][0] = nt
        buf[cap, :3] = nt
    buf[-1, :5] = (E, nfill, post_exp, live_min, ovf)
    return out, buf
