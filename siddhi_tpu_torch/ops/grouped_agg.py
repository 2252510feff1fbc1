"""Grouped window / running aggregation step — the device QuerySelector.

Counterpart of ``siddhi_tpu/ops/grouped_agg.py`` (K7): the length-window
and running step ``build_grouped_step`` (``:119``) and the time-window
step ``build_grouped_time_step`` (``:283``), with the same carries, the
same 13-tuple output contract (14 with the NUMGUARD sentinel plane) and
the same numerics:

  - float bank: float32 values with two-float (TwoSum) running sums;
  - int bank: int32 values with exact sums split at 2^16 (hi = v >> 16,
    lo = v & 65535), reassembled to int64 on the host;
  - windowed min/max as masked reductions over the ring's live slots of
    the arriving event's group; forever extrema add-only.

The port computes each step twice:

  - :func:`grouped_step_plain` / :func:`grouped_time_step_plain` —
    PyTorch ops vectorised over the P lanes, a Python loop over the T
    events.  Used for CPU tensors and by the checks on the card;
  - the hand-written Hopper kernels ``csrc/grouped_agg.cu`` (K7a
    ``gagg_step``, K7b ``gagg_time_step``) — launched by
    :func:`grouped_step` / :func:`grouped_time_step` for CUDA tensors.
    They split a lane's events across the card (ranks and per-group
    chains by tiled counting passes, a serial walk per group for the
    running sums, a range per event for the windowed planes);
    :func:`grouped_split_model` is the CPU model of their passes.

Where the JAX step's bits are subtle the twin and the kernel follow it:

  - the evicted value is read as ``sum(where(onehot, ring, 0))``, which
    turns a ``-0.0`` slot into ``+0.0``: both add ``+0.0`` to the slot;
  - ``jnp.min``/``jnp.max``, ``.at[].min``/``.at[].max`` are IEEE
    minimum/maximum: NaN propagates and ``-0.0 < +0.0``.  torch's
    ``minimum`` and CUDA's ``fminf`` do neither, so both are written out
    (:func:`_fmin`, :func:`_masked_extreme`);
  - the time step's float sums reduce by the pairwise two-float tree of
    ``_pair_tree_sum`` (element i + element i + half, level by level).

NaN payloads are not part of the contract (the card's arithmetic makes
its own canonical NaN); every other bit is.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ._kernels import load_kernel
from .windowed_agg import kernel_device

INT_EXACT_MAX = 1 << 31        # |int value| bound for i32 device lanes
INT_GROUP_MAX = 1 << 15        # live entries per group for exact int sums
_SPLIT = 65536                 # int hi/lo split base (16 bits)

I32_MAX = int(np.iinfo(np.int32).max)
I32_MIN = int(np.iinfo(np.int32).min)
TS_EMPTY = I32_MIN             # empty-slot timestamp marker

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


class GroupedAggCarry(NamedTuple):
    ring_f: torch.Tensor    # [P, W, VF] f32
    ring_i: torch.Tensor    # [P, W, VI] i32
    ring_gid: torch.Tensor  # [P, W] i32
    pos: torch.Tensor       # [P] i32
    cnt: torch.Tensor       # [P] i32
    fsum_hi: torch.Tensor   # [P, G, VF] f32 two-float hi
    fsum_lo: torch.Tensor   # [P, G, VF] f32 two-float lo
    isum_hi: torch.Tensor   # [P, G, VI] i32 split hi
    isum_lo: torch.Tensor   # [P, G, VI] i32 split lo
    gcnt: torch.Tensor      # [P, G] i32
    fmin_f: torch.Tensor    # [P, G, VF] f32 add-only min
    fmax_f: torch.Tensor    # [P, G, VF] f32 add-only max
    fmin_i: torch.Tensor    # [P, G, VI] i32 add-only min
    fmax_i: torch.Tensor    # [P, G, VI] i32 add-only max


class GroupedTimeCarry(NamedTuple):
    ring_f: torch.Tensor    # [P, W, VF] f32
    ring_i: torch.Tensor    # [P, W, VI] i32
    ring_gid: torch.Tensor  # [P, W] i32
    ring_ts: torch.Tensor   # [P, W] i32 offsets (TS_EMPTY = empty)
    pos: torch.Tensor       # [P] i32
    cnt: torch.Tensor       # [P] i32
    overflow: torch.Tensor  # [P] bool — sticky: a still-in-window entry
    #                         was evicted; the caller grows and replays
    fmin_f: torch.Tensor    # [P, G, VF] add-only extrema (forever lanes)
    fmax_f: torch.Tensor
    fmin_i: torch.Tensor    # [P, G, VI]
    fmax_i: torch.Tensor


LENGTH_DTYPES = (_F32, _I32, _I32, _I32, _I32, _F32, _F32, _I32, _I32,
                 _I32, _F32, _F32, _I32, _I32)
TIME_DTYPES = (_F32, _I32, _I32, _I32, _I32, _I32, _BOOL, _F32, _F32,
               _I32, _I32)


def make_grouped_carry(n_lanes: int, window: int, n_groups: int,
                       n_float: int, n_int: int,
                       device=None) -> GroupedAggCarry:
    P, W, G, VF, VI = n_lanes, window, n_groups, n_float, n_int
    z = dict(device=kernel_device(device))
    return GroupedAggCarry(
        ring_f=torch.zeros((P, W, VF), dtype=_F32, **z),
        ring_i=torch.zeros((P, W, VI), dtype=_I32, **z),
        ring_gid=torch.full((P, W), -1, dtype=_I32, **z),
        pos=torch.zeros((P,), dtype=_I32, **z),
        cnt=torch.zeros((P,), dtype=_I32, **z),
        fsum_hi=torch.zeros((P, G, VF), dtype=_F32, **z),
        fsum_lo=torch.zeros((P, G, VF), dtype=_F32, **z),
        isum_hi=torch.zeros((P, G, VI), dtype=_I32, **z),
        isum_lo=torch.zeros((P, G, VI), dtype=_I32, **z),
        gcnt=torch.zeros((P, G), dtype=_I32, **z),
        # ±inf sentinels: an infinite input must reach min/max as is
        fmin_f=torch.full((P, G, VF), float("inf"), dtype=_F32, **z),
        fmax_f=torch.full((P, G, VF), float("-inf"), dtype=_F32, **z),
        fmin_i=torch.full((P, G, VI), I32_MAX, dtype=_I32, **z),
        fmax_i=torch.full((P, G, VI), I32_MIN, dtype=_I32, **z))


def make_grouped_time_carry(n_lanes: int, capacity: int, n_groups: int,
                            n_float: int, n_int: int,
                            device=None) -> GroupedTimeCarry:
    P, W, G, VF, VI = n_lanes, capacity, n_groups, n_float, n_int
    z = dict(device=kernel_device(device))
    return GroupedTimeCarry(
        ring_f=torch.zeros((P, W, VF), dtype=_F32, **z),
        ring_i=torch.zeros((P, W, VI), dtype=_I32, **z),
        ring_gid=torch.full((P, W), -1, dtype=_I32, **z),
        ring_ts=torch.full((P, W), TS_EMPTY, dtype=_I32, **z),
        pos=torch.zeros((P,), dtype=_I32, **z),
        cnt=torch.zeros((P,), dtype=_I32, **z),
        overflow=torch.zeros((P,), dtype=_BOOL, **z),
        fmin_f=torch.full((P, G, VF), float("inf"), dtype=_F32, **z),
        fmax_f=torch.full((P, G, VF), float("-inf"), dtype=_F32, **z),
        fmin_i=torch.full((P, G, VI), I32_MAX, dtype=_I32, **z),
        fmax_i=torch.full((P, G, VI), I32_MIN, dtype=_I32, **z))


def carry_from_reference(state, device=None):
    """The port's carry from the JAX package's: ``state`` is the dict
    ``CompiledGroupedAgg.current_state()`` returns, or its ``"carry"``
    list of numpy leaves.  14 leaves make a :class:`GroupedAggCarry`, 11
    a :class:`GroupedTimeCarry`; every leaf is pinned to the JAX dtype
    (float32, int32, bool) on ``device`` (default: the card).  Every carry
    a step produces fills its ring from slot 0 (``pos == cnt`` while
    ``cnt < W``), and the kernels place the ring's entries by it: a state
    that breaks it raises ``ValueError``."""
    leaves = state["carry"] if isinstance(state, dict) else state
    if len(leaves) == len(GroupedAggCarry._fields):
        cls, dts = GroupedAggCarry, LENGTH_DTYPES
    elif len(leaves) == len(GroupedTimeCarry._fields):
        cls, dts = GroupedTimeCarry, TIME_DTYPES
    else:
        raise ValueError(f"grouped carry has 14 (length) or 11 (time) "
                         f"leaves, got {len(leaves)}")
    W = np.asarray(leaves[2]).shape[1]
    pos = np.asarray(leaves[cls._fields.index("pos")])
    cnt = np.asarray(leaves[cls._fields.index("cnt")])
    bad = np.flatnonzero((cnt < W) & (pos != cnt)) if W else []
    if len(bad):
        p = int(bad[0])
        raise ValueError(f"grouped carry: lane {p} has cnt {int(cnt[p])} < "
                         f"W {W} but pos {int(pos[p])} != cnt; a ring fills "
                         f"from slot 0")
    dev = kernel_device(device)
    return cls(*[torch.tensor(np.asarray(a), device=dev).to(dt)
                 .contiguous() for a, dt in zip(leaves, dts)])


# --------------------------------------------------------------- numerics

def _two_sum(a, b):
    """Error-free transform: a + b = s + err exactly (Knuth TwoSum)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _pair_add(hi, lo, x, ok):
    """Add x to the (hi, lo) two-float accumulators where ok."""
    s, e = _two_sum(hi, x)
    lo2 = lo + e
    hi2 = s + lo2                      # fast renormalisation keeps the
    lo3 = lo2 - (hi2 - s)              # pair non-overlapping
    return torch.where(ok, hi2, hi), torch.where(ok, lo3, lo)


_NAN = float("nan")


def _fmin(a, b):
    """IEEE minimum (lax.min): NaN propagates, -0.0 < +0.0."""
    r = torch.where((a < b) | ((a == b) & torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(r, _NAN), r)


def _fmax(a, b):
    """IEEE maximum (lax.max): NaN propagates, +0.0 > -0.0."""
    r = torch.where((a > b) | ((a == b) & torch.signbit(b)), a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(r, _NAN), r)


def _order_key(x):
    """float32 → int32 whose order is the float order with -0.0 < +0.0
    (NaN excluded)."""
    b = x.view(_I32)
    return b ^ ((b >> 31) & I32_MAX)


def _from_order_key(k):
    return (k ^ ((k >> 31) & I32_MAX)).view(_F32)


def _masked_extreme(vals, live, dim: int, smallest: bool):
    """jnp.min(where(live, vals, inf)) (or the max with -inf) over
    ``dim``: IEEE semantics as :func:`_fmin`."""
    fill = float("inf") if smallest else float("-inf")
    x = torch.where(live, vals, torch.full_like(vals, fill))
    k = _order_key(x.contiguous())
    red = k.amin(dim=dim) if smallest else k.amax(dim=dim)
    r = _from_order_key(red.contiguous())
    return torch.where(torch.isnan(x).any(dim=dim),
                       torch.full_like(r, _NAN), r)


def _masked_int_extreme(vals, live, dim: int, smallest: bool):
    fill = I32_MAX if smallest else I32_MIN
    x = torch.where(live, vals, torch.full_like(vals, fill))
    return x.amin(dim=dim) if smallest else x.amax(dim=dim)


def _pair_tree_sum(vals, live, dim: int = 0):
    """Masked two-float tree reduction over ``dim`` (its size must be a
    power of two): element i meets element i + half, level by level, so
    the (hi, lo) pair is the JAX package's bit for bit."""
    hi = torch.where(live, vals, torch.zeros_like(vals)).movedim(dim, 0)
    lo = torch.zeros_like(hi)
    w = hi.shape[0]
    while w > 1:
        half = w // 2
        a_hi, a_lo = hi[:half], lo[:half]
        b_hi, b_lo = hi[half:w], lo[half:w]
        s, e = _two_sum(a_hi, b_hi)
        lo2 = a_lo + b_lo + e
        hi = s + lo2
        lo = lo2 - (hi - s)
        w = half
    return hi[0], lo[0]


def sentinel_plane(fsum_hi, isum_hi, isum_lo, gcnt) -> torch.Tensor:
    """[3] int32 NUMGUARD flags folded from the post-step accumulators:
    [int sums past 90% of 2^31, count lanes past 90% of 2^31, non-finite
    float-sum lanes] (float32 reassembly, as the JAX package: only the
    magnitude matters for a 0.9x threshold)."""
    near = torch.tensor(0.9 * INT_EXACT_MAX, dtype=_F32,
                        device=fsum_hi.device)
    isum = isum_hi.to(_F32) * float(_SPLIT) + isum_lo.to(_F32)
    n_int = (isum.abs() >= near).sum(dtype=_I32)
    n_cnt = (gcnt.to(_F32) >= near).sum(dtype=_I32)
    n_fin = (~torch.isfinite(fsum_hi)).sum(dtype=_I32)
    return torch.stack([n_int, n_cnt, n_fin])


def reassemble_int_sums(sum_hi: np.ndarray, sum_lo: np.ndarray
                        ) -> np.ndarray:
    """hi/lo split partial sums → exact int64 totals (host egress side)."""
    return sum_hi.astype(np.int64) * _SPLIT + sum_lo.astype(np.int64)


# ------------------------------------------------------------ plain steps

def _empty_outs(P, T, VF, VI, dev):
    f = lambda: torch.empty((P, T, VF), dtype=_F32, device=dev)  # noqa: E731
    i = lambda: torch.empty((P, T, VI), dtype=_I32, device=dev)  # noqa: E731
    return (f(), f(), i(), i(), torch.empty((P, T), dtype=_I32, device=dev),
            f(), f(), i(), i(), f(), f(), i(), i())


def _forever_update(lane, g, ok, xf, xi, mnf, mxf, mni, mxi):
    okv = ok[:, None]
    m = mnf[lane, g]
    mnf[lane, g] = torch.where(okv, _fmin(m, xf), m)
    m = mxf[lane, g]
    mxf[lane, g] = torch.where(okv, _fmax(m, xf), m)
    m = mni[lane, g]
    mni[lane, g] = torch.where(okv, torch.minimum(m, xi), m)
    m = mxi[lane, g]
    mxi[lane, g] = torch.where(okv, torch.maximum(m, xi), m)


def grouped_step_plain(window: int, want_minmax: bool, want_forever: bool,
                       numguard: bool = False) -> Callable:
    """``step(carry, vals_f [P,T,VF] f32, vals_i [P,T,VI] i32, gids [P,T]
    i32, accepted [P,T] bool) → (carry, outs)`` in plain PyTorch: the
    contract of the JAX package's ``build_grouped_step`` (13 outputs of
    [P, T, ...], a 14th [3] sentinel plane with ``numguard``).  Window 0
    is the running mode.  Functional: the input carry is not modified."""
    W = window
    upd_forever = want_forever or (want_minmax and W == 0)

    def step(carry: GroupedAggCarry, vals_f, vals_i, gids, accepted):
        (rf, ri, rgid, pos, cnt, fhi, flo, ihi, ilo, gc,
         mnf, mxf, mni, mxi) = [a.clone() for a in carry]
        P, T = gids.shape
        VF, VI = vals_f.shape[2], vals_i.shape[2]
        dev = gids.device
        lane = torch.arange(P, device=dev)
        slot = torch.arange(max(W, 1), device=dev)
        izero = torch.zeros((P, VI), dtype=_I32, device=dev)
        outs = _empty_outs(P, T, VF, VI, dev)
        for t in range(T):
            xf, xi = vals_f[:, t], vals_i[:, t]
            g = gids[:, t].long()
            ok = accepted[:, t]
            if W > 0:
                p = pos.long()
                evict = ok & (cnt == W)
                ev = evict[:, None]
                # the one-hot sum: a -0.0 slot reads as +0.0
                old_f = rf[lane, p] + 0.0
                old_i = ri[lane, p]
                old_g = rgid[lane, p].long()
                h2, l2 = _pair_add(fhi[lane, old_g], flo[lane, old_g],
                                   -old_f, ev)
                fhi[lane, old_g] = h2
                flo[lane, old_g] = l2
                ihi[lane, old_g] += torch.where(ev, -(old_i >> 16), izero)
                ilo[lane, old_g] += torch.where(
                    ev, -(old_i & (_SPLIT - 1)), izero)
                gc[lane, old_g] -= evict.to(_I32)
                okv = ok[:, None]
                rf[lane, p] = torch.where(okv, xf, rf[lane, p])
                ri[lane, p] = torch.where(okv, xi, ri[lane, p])
                rgid[lane, p] = torch.where(ok, gids[:, t], rgid[lane, p])
                pos = torch.where(ok, (pos + 1) % W, pos)
                cnt = torch.where(ok, torch.clamp(cnt + 1, max=W), cnt)
            okv = ok[:, None]
            h2, l2 = _pair_add(fhi[lane, g], flo[lane, g], xf, okv)
            fhi[lane, g] = h2
            flo[lane, g] = l2
            ihi[lane, g] += torch.where(okv, xi >> 16, izero)
            ilo[lane, g] += torch.where(okv, xi & (_SPLIT - 1), izero)
            gc[lane, g] += ok.to(_I32)
            if upd_forever:
                _forever_update(lane, g, ok, xf, xi, mnf, mxf, mni, mxi)
            a_mnf, a_mxf = mnf[lane, g], mxf[lane, g]
            a_mni, a_mxi = mni[lane, g], mxi[lane, g]
            if want_minmax and W > 0:
                live = ((slot[None, :] < cnt[:, None]) &
                        (rgid == gids[:, t][:, None]))[..., None]
                w = (_masked_extreme(rf, live, 1, True),
                     _masked_extreme(rf, live, 1, False),
                     _masked_int_extreme(ri, live, 1, True),
                     _masked_int_extreme(ri, live, 1, False))
            else:
                w = (a_mnf, a_mxf, a_mni, a_mxi)
            vals = (fhi[lane, g], flo[lane, g], ihi[lane, g], ilo[lane, g],
                    gc[lane, g]) + w + (a_mnf, a_mxf, a_mni, a_mxi)
            for o, v in zip(outs, vals):
                o[:, t] = v
        nc = GroupedAggCarry(rf, ri, rgid, pos, cnt, fhi, flo, ihi, ilo, gc,
                             mnf, mxf, mni, mxi)
        if numguard:
            outs = outs + (sentinel_plane(nc.fsum_hi, nc.isum_hi,
                                          nc.isum_lo, nc.gcnt),)
        return nc, outs

    return step


def grouped_time_step_plain(window_ms: int, capacity: int,
                            want_forever: bool) -> Callable:
    """``step(carry, vals_f, vals_i, gids, ts [P,T] i32 offsets, accepted)
    → (carry, outs)`` in plain PyTorch: the contract of the JAX package's
    ``build_grouped_time_step`` (13 outputs; the carry's sticky
    ``overflow`` lane flags an evicted entry still inside the window).
    Functional: the input carry is not modified."""
    W = capacity

    def step(carry: GroupedTimeCarry, vals_f, vals_i, gids, ts, accepted):
        (rf, ri, rgid, rts, pos, cnt, ovf, mnf, mxf, mni,
         mxi) = [a.clone() for a in carry]
        P, T = gids.shape
        VF, VI = vals_f.shape[2], vals_i.shape[2]
        dev = gids.device
        lane = torch.arange(P, device=dev)
        iota = torch.arange(W, device=dev)
        izero = torch.zeros((), dtype=_I32, device=dev)
        outs = _empty_outs(P, T, VF, VI, dev)
        for t in range(T):
            xf, xi = vals_f[:, t], vals_i[:, t]
            gt = gids[:, t]
            g = gt.long()
            tt = ts[:, t]
            ok = accepted[:, t]
            p = pos.long()
            lo_ts = tt - window_ms
            evicting_live = (cnt == W) & (rts[lane, p] > lo_ts)
            ovf = ovf | (ok & evicting_live)
            okv = ok[:, None]
            rf[lane, p] = torch.where(okv, xf, rf[lane, p])
            ri[lane, p] = torch.where(okv, xi, ri[lane, p])
            rgid[lane, p] = torch.where(ok, gt, rgid[lane, p])
            rts[lane, p] = torch.where(ok, tt, rts[lane, p])
            pos = torch.where(ok, (pos + 1) % W, pos)
            cnt = torch.where(ok, torch.clamp(cnt + 1, max=W), cnt)
            if want_forever:
                _forever_update(lane, g, ok, xf, xi, mnf, mxf, mni, mxi)
            live2 = ((iota[None, :] < cnt[:, None]) &
                     (rts > lo_ts[:, None]) & (rgid == gt[:, None]))
            live = live2[..., None]
            s_f, s_f_lo = _pair_tree_sum(rf, live, dim=1)
            vals = (s_f, s_f_lo,
                    torch.where(live, ri >> 16, izero).sum(1, dtype=_I32),
                    torch.where(live, ri & (_SPLIT - 1), izero)
                    .sum(1, dtype=_I32),
                    live2.sum(1, dtype=_I32),
                    _masked_extreme(rf, live, 1, True),
                    _masked_extreme(rf, live, 1, False),
                    _masked_int_extreme(ri, live, 1, True),
                    _masked_int_extreme(ri, live, 1, False),
                    mnf[lane, g], mxf[lane, g], mni[lane, g], mxi[lane, g])
            for o, v in zip(outs, vals):
                o[:, t] = v
        return GroupedTimeCarry(rf, ri, rgid, rts, pos, cnt, ovf, mnf, mxf,
                                mni, mxi), outs

    return step


# ------------------------------------------------------ the split design

#: threads of a CTA of the kernels' tiled passes; the longest live range
#: of a group one thread reduces alone (csrc/grouped_agg.cu kBlock,
#: kShort); the count matrices' budget (kCountBytes)
SPLIT_BLOCK = 256
SPLIT_SHORT = 32
SPLIT_COUNT_BYTES = 64 << 20


def split_tile(P: int, T: int, W: int, G: int) -> int:
    """Events (or carry entries) one CTA of the tiled passes takes, as
    ``csrc/grouped_agg.cu split_tile`` decides: one block of threads,
    doubled while the per-tile group counts of the P lanes would pass
    SPLIT_COUNT_BYTES."""
    tile = SPLIT_BLOCK
    while tile < max(T, W, 1):
        n_tiles = -(-W // tile) + 2 * -(-T // tile)
        if P * n_tiles * G * 4 <= SPLIT_COUNT_BYTES:
            break
        tile *= 2
    return tile


def _wrap32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _tree_node(a, b):
    """One node of _pair_tree_sum: (hi, lo) pairs a (the lower slots)
    and b combined."""
    s, e = _two_sum(a[0], b[0])
    lo2 = (a[1] + b[1]) + e
    h = s + lo2
    return h, lo2 - (h - s)


def _sparse_tree(leaves, W: int, zero):
    """_pair_tree_sum over W slots of which only ``leaves`` ((slot, hi)
    pairs) are live, as the kernel computes it: the live slots ordered by
    their bit-reversed index, so that each level's siblings (i and
    i + half) are neighbours in the list; a node whose sibling is not
    live meets (+0.0, +0.0) on its side, the operations of the dense
    tree."""
    bits = max(W.bit_length() - 1, 0)

    def rev(i):
        return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0

    nodes = [(s, (h, zero)) for s, h in sorted(leaves,
                                               key=lambda x: rev(x[0]))]
    w = W
    while w > 1:
        half = w >> 1
        nxt, k = [], 0
        while k < len(nodes):
            i, node = nodes[k]
            if i & half:
                pair, k = ((zero, zero), node), k + 1
            elif k + 1 < len(nodes) and nodes[k + 1][0] == i + half:
                pair, k = (node, nodes[k + 1][1]), k + 2
            else:
                pair, k = (node, (zero, zero)), k + 1
            nxt.append((i & (half - 1), _tree_node(*pair)))
        nodes, w = nxt, half
    return nodes[0][1] if nodes else (zero, zero)


class _Chains(NamedTuple):
    """Passes A and B of the split, per lane: E (the lane's entries by
    virtual index: the carry's live entries oldest first, then the
    accepted events at cnt0 + rank), each group's entry chain ENT
    (virtual indices, ascending) and event chain EVC (event indices,
    ascending), and per event its window's end hi (entries before it
    and itself) and its group's entries before hi (b)."""
    first: np.ndarray       # [P] the slot of virtual index 0
    n_acc: np.ndarray       # [P] accepted events of the block
    ent: np.ndarray         # [P, W + T] ENT, group after group
    ent_off: np.ndarray     # [P, G]
    ent_len: np.ndarray     # [P, G]
    evc: np.ndarray         # [P, T] EVC, group after group
    evc_off: np.ndarray     # [P, G]
    evc_len: np.ndarray     # [P, G]
    hi: np.ndarray          # [P, T]
    b: np.ndarray           # [P, T]
    e_f: torch.Tensor       # [P, W + T, VF]
    e_i: torch.Tensor       # [P, W + T, VI]
    e_g: np.ndarray         # [P, W + T]
    e_ts: Optional[np.ndarray]


def _split_chains(carry, vals_f, vals_i, gids, ts, accepted, tile: int
                  ) -> _Chains:
    """Passes A and B, as the kernel's count, scan and scatter passes do
    them: tiles of ``tile`` items, the carry's ceil(W / tile) tiles of
    entries before the block's tiles of events."""
    W = int(carry.ring_gid.shape[1])
    P, T = (int(x) for x in gids.shape)
    G = int(carry.fmin_f.shape[1])
    g_np = gids.numpy().astype(np.int64)
    ok_np = accepted.numpy().astype(bool)
    cnt0 = carry.cnt.numpy().astype(np.int64)
    rg0 = carry.ring_gid.numpy().astype(np.int64)
    first = np.where(cnt0 < W, 0, carry.pos.numpy().astype(np.int64))
    n_tc, n_tb = -(-W // tile), -(-T // tile)

    # A: per tile, its accepted events and per group its events (EVC) and
    # entries (ENT); per item its ranks in the tile
    acc_in = np.zeros((P, T), np.int64)
    kall_in = np.zeros((P, T), np.int64)
    kacc_in = np.zeros((P, T), np.int64)
    kent_in = np.zeros((P, W), np.int64)
    tile_acc = np.zeros((P, n_tb), np.int64)
    cnt_ent = np.zeros((P, n_tc + n_tb, G), np.int64)
    cnt_evc = np.zeros((P, n_tb, G), np.int64)
    for p in range(P):
        for v in range(int(cnt0[p])):
            q = rg0[p, (first[p] + v) % W]
            if 0 <= q < G:                  # (a carry a step made: always)
                kent_in[p, v] = cnt_ent[p, v // tile, q]
                cnt_ent[p, v // tile, q] += 1
        for t in range(T):
            b, q = t // tile, g_np[p, t]
            acc_in[p, t] = tile_acc[p, b]
            kall_in[p, t] = cnt_evc[p, b, q]
            kacc_in[p, t] = cnt_ent[p, n_tc + b, q]
            cnt_evc[p, b, q] += 1
            if ok_np[p, t]:
                cnt_ent[p, n_tc + b, q] += 1
                tile_acc[p, b] += 1

    # B: the scans (tile order, then group order), then the scatter
    def excl(x, axis):
        return np.cumsum(x, axis=axis) - x
    tile_base = excl(tile_acc, 1)
    ent_base, evc_base = excl(cnt_ent, 1), excl(cnt_evc, 1)
    ent_len, evc_len = cnt_ent.sum(1), cnt_evc.sum(1)
    ent_off, evc_off = excl(ent_len, 1), excl(evc_len, 1)
    NE = W + T
    src = np.full((P, NE), -1, np.int64)    # E's source: slot, or event
    from_ring = np.zeros((P, NE), bool)
    ent = np.full((P, NE), -1, np.int64)
    evc = np.zeros((P, T), np.int64)
    hi = np.zeros((P, T), np.int64)
    bb = np.zeros((P, T), np.int64)
    for p in range(P):
        for v in range(int(cnt0[p])):
            s = (first[p] + v) % W
            src[p, v], from_ring[p, v] = s, True
            q = rg0[p, s]
            if 0 <= q < G:
                ent[p, ent_off[p, q] + ent_base[p, v // tile, q] +
                    kent_in[p, v]] = v
        for t in range(T):
            b, q, ok = t // tile, g_np[p, t], int(ok_np[p, t])
            r = tile_base[p, b] + acc_in[p, t]
            k = ent_base[p, n_tc + b, q] + kacc_in[p, t]
            hi[p, t] = cnt0[p] + r + ok
            bb[p, t] = k + ok
            evc[p, evc_off[p, q] + evc_base[p, b, q] + kall_in[p, t]] = t
            if ok:
                src[p, cnt0[p] + r] = t
                ent[p, ent_off[p, q] + k] = cnt0[p] + r
    lane = torch.arange(P)[:, None]
    rs = torch.from_numpy(np.where(from_ring, src, 0))
    es = torch.from_numpy(np.where(from_ring | (src < 0), 0, src))
    fr = torch.from_numpy(from_ring)

    def gather(ring, ev):
        e = (ev[lane, es] if T else
             torch.zeros((P, NE) + tuple(ev.shape[2:]), dtype=ev.dtype))
        if not W:
            return e
        m = fr.reshape(fr.shape + (1,) * (e.dim() - 2))
        return torch.where(m, ring[lane, rs], e)
    time = isinstance(carry, GroupedTimeCarry)
    return _Chains(
        first=first, n_acc=tile_acc.sum(1), ent=ent,
        ent_off=ent_off, ent_len=ent_len, evc=evc, evc_off=evc_off,
        evc_len=evc_len, hi=hi, b=bb,
        e_f=gather(carry.ring_f, vals_f), e_i=gather(carry.ring_i, vals_i),
        e_g=gather(carry.ring_gid, gids).numpy().astype(np.int64),
        e_ts=(gather(carry.ring_ts, ts).numpy().astype(np.int64)
              if time else None))


_ON = torch.tensor(True)


def _split_walk(ch: _Chains, carry, out, outs, vals_f, vals_i, accepted,
                want_minmax: bool, want_forever: bool):
    """Pass C: one walk per (lane, group) over its event chain, each of
    its entries' evictions (K7a with a window) merged in: entry v has left
    the window at event t when v < hi - W, so every such entry is evicted
    before t's add (the entry t itself evicts, v = hi - 1 - W, included;
    the rest after the group's last event, while v < cnt0 + accepted -
    W).  The kernel reads both chains as chain-ordered copies.  Writes
    the sums, count and forever planes at every event of the group
    (K7a's windowed planes too without a windowed min/max), then the
    group's slabs into ``out``."""
    time = isinstance(carry, GroupedTimeCarry)
    W = int(carry.ring_gid.shape[1])
    P, T = (int(x) for x in accepted.shape)
    G = int(carry.fmin_f.shape[1])
    ok_np = accepted.numpy().astype(bool)
    cnt0 = carry.cnt.numpy().astype(np.int64)
    upd_forever = want_forever or (want_minmax and W == 0)
    windowed = want_minmax and W > 0
    for p in range(P):
        for q in range(G):
            mn_f, mx_f = carry.fmin_f[p, q], carry.fmax_f[p, q]
            mn_i, mx_i = carry.fmin_i[p, q], carry.fmax_i[p, q]
            if not time:
                fh, fl = carry.fsum_hi[p, q], carry.fsum_lo[p, q]
                ih, il = carry.isum_hi[p, q], carry.isum_lo[p, q]
                gc = carry.gcnt[p, q]
            chain = ch.ent[p, ch.ent_off[p, q]:][:ch.ent_len[p, q]]
            n_ev = 0 if time or not W else len(chain)
            end = cnt0[p] + ch.n_acc[p]
            k = 0
            events = ch.evc[p, ch.evc_off[p, q]:][:ch.evc_len[p, q]]
            for t in list(events) + [T]:
                lim = (ch.hi[p, t] if t < T else end) - W
                while k < n_ev and chain[k] < lim:
                    v = chain[k]
                    fh, fl = _pair_add(fh, fl, -(ch.e_f[p, v] + 0.0), _ON)
                    ih = ih + -(ch.e_i[p, v] >> 16)
                    il = il + -(ch.e_i[p, v] & (_SPLIT - 1))
                    gc = gc - 1
                    k += 1
                if t == T:
                    break
                if ok_np[p, t]:
                    xf, xi = vals_f[p, t], vals_i[p, t]
                    if not time:
                        fh, fl = _pair_add(fh, fl, xf, _ON)
                        ih = ih + (xi >> 16)
                        il = il + (xi & (_SPLIT - 1))
                        gc = gc + 1
                    if upd_forever:
                        mn_f, mx_f = _fmin(mn_f, xf), _fmax(mx_f, xf)
                        mn_i = torch.minimum(mn_i, xi)
                        mx_i = torch.maximum(mx_i, xi)
                ext = (mn_f, mx_f, mn_i, mx_i)
                row = {9 + j: x for j, x in enumerate(ext)}
                if not time:
                    row.update(enumerate((fh, fl, ih, il, gc)))
                    if not windowed:
                        row.update({5 + j: x for j, x in enumerate(ext)})
                for j, x in row.items():
                    outs[j][p, t] = x
            slabs = dict(fmin_f=mn_f, fmax_f=mx_f, fmin_i=mn_i, fmax_i=mx_i)
            if not time:
                slabs.update(fsum_hi=fh, fsum_lo=fl, isum_hi=ih,
                             isum_lo=il, gcnt=gc)
            for name, x in slabs.items():
                getattr(out, name)[p, q] = x


def _split_windows(ch: _Chains, carry, out, outs, gids, ts, accepted,
                   window_ms: int, short: int):
    """Pass D: every event's windowed planes (K7a: min/max; K7b: sums,
    count, min/max, and the ring overflow).  Its group's live entries are
    ENT's range of virtual indices in [max(0, hi - W), hi) that ends at b
    (K7b: those with ts > the event's ts - window_ms)."""
    time = isinstance(carry, GroupedTimeCarry)
    W = int(carry.ring_gid.shape[1])
    P, T = (int(x) for x in gids.shape)
    VF, VI = int(carry.ring_f.shape[2]), int(carry.ring_i.shape[2])
    g_np = gids.numpy().astype(np.int64)
    ok_np = accepted.numpy().astype(bool)
    ts_np = ts.numpy().astype(np.int64) if time else None
    zero = torch.zeros(VF, dtype=_F32)
    inf = torch.full((VF,), float("inf"), dtype=_F32)
    for p in range(P):
        for t in range(T):
            q, hi, b = g_np[p, t], ch.hi[p, t], ch.b[p, t]
            lo = max(0, hi - W)
            chain = ch.ent[p, ch.ent_off[p, q]:]
            lo_ts = _wrap32(ts_np[p, t] - window_ms) if time else 0
            if b - 1 - short >= 0 and chain[b - 1 - short] >= lo:
                # a warp: K7a walks the chain down 32 entries a step
                # until one falls below the window; K7b the dense tree
                if not time:
                    live, top = [], b - 1
                    while True:
                        step = [chain[k] for k in range(top, top - 32, -1)
                                if k >= 0 and chain[k] >= lo]
                        live += step
                        if len(step) < 32:
                            break
                        top -= 32
                    tree = None
                else:
                    d = (hi - 1 + ch.first[p] - np.arange(W)) % W
                    v = hi - 1 - d
                    ok_slot = v >= 0
                    vv = np.where(ok_slot, v, 0)
                    m = (ok_slot & (ch.e_g[p, vv] == q) &
                         (ch.e_ts[p, vv] > lo_ts))
                    live = list(vv[m])
                    leaves = ch.e_f[p, torch.from_numpy(vv)]
                    tree = _pair_tree_sum(
                        leaves, torch.from_numpy(m)[:, None], dim=0)
            else:                           # one thread walks the range
                live, k = [], b - 1
                while k >= 0 and chain[k] >= lo:
                    if not time or ch.e_ts[p, chain[k]] > lo_ts:
                        live.append(chain[k])
                    k -= 1
                tree = None
                if time:
                    tree = _sparse_tree(
                        [((ch.first[p] + v) % W, ch.e_f[p, v])
                         for v in live], W, zero)
            mn, mx = inf, -inf
            for v in live:
                mn, mx = _fmin(mn, ch.e_f[p, v]), _fmax(mx, ch.e_f[p, v])
            xi = ch.e_i[p, live].to(torch.int64) if live else \
                torch.zeros((0, VI), dtype=torch.int64)
            outs[5][p, t], outs[6][p, t] = mn, mx
            outs[7][p, t] = (xi.amin(0) if live else
                             torch.full((VI,), I32_MAX)).to(_I32)
            outs[8][p, t] = (xi.amax(0) if live else
                             torch.full((VI,), I32_MIN)).to(_I32)
            if time:
                outs[0][p, t], outs[1][p, t] = tree
                for j, part in ((2, xi >> 16), (3, xi & (_SPLIT - 1))):
                    outs[j][p, t] = torch.tensor(
                        [_wrap32(int(x)) for x in part.sum(0)], dtype=_I32)
                outs[4][p, t] = len(live)
                if ok_np[p, t] and hi - 1 - W >= 0 and \
                        ch.e_ts[p, hi - 1 - W] > lo_ts:
                    out.overflow[p] = True


def _split_ring(ch: _Chains, carry, out):
    """Pass E: each slot of the ring takes the newest entry that lands in
    it (an entry of the block; a slot the block leaves keeps the carry's),
    then pos and cnt move on by the block's accepted events."""
    W = int(carry.ring_gid.shape[1])
    if not W:
        return
    P = int(carry.cnt.shape[0])
    cnt0 = carry.cnt.numpy().astype(np.int64)     # copies: in place,
    pos0 = carry.pos.numpy().astype(np.int64)     # out is the carry
    names = ["ring_f", "ring_i", "ring_gid"] + (
        ["ring_ts"] if isinstance(carry, GroupedTimeCarry) else [])
    srcs = [ch.e_f, ch.e_i, torch.from_numpy(ch.e_g).to(_I32)] + (
        [torch.from_numpy(ch.e_ts).to(_I32)] if len(names) == 4 else [])
    for p in range(P):
        end = cnt0[p] + ch.n_acc[p]
        for s in range(W):
            v = end - 1 - (end - 1 + ch.first[p] - s) % W
            if v >= cnt0[p]:
                for name, e in zip(names, srcs):
                    getattr(out, name)[p, s] = e[p, v]
    out.pos.copy_(torch.from_numpy((pos0 + ch.n_acc) % W).to(_I32))
    out.cnt.copy_(torch.from_numpy(np.minimum(cnt0 + ch.n_acc, W))
                  .to(_I32))


def grouped_split_model(carry, vals_f, vals_i, gids, ts, accepted, *,
                        want_minmax: bool = False, want_forever: bool = False,
                        window_ms: int = 0, inplace: bool = False,
                        tile: Optional[int] = None, short: int = SPLIT_SHORT):
    """The CPU model of ``csrc/grouped_agg.cu``: K7a's contract
    (:func:`grouped_step_plain`; ``ts`` None) for a
    :class:`GroupedAggCarry`, K7b's (:func:`grouped_time_step_plain`) for a
    :class:`GroupedTimeCarry`, computed by the kernels' passes with
    ``tile`` events to a tile (default :func:`split_tile`) and ranges of
    at most ``short`` entries reduced by one thread:

      A, B  ranks, chains and the entry array (:func:`_split_chains`);
      C     the chain walk per (lane, group) (:func:`_split_walk`): K7a's
            sums and counts, the forever extrema of both;
      D     the windowed planes per event (:func:`_split_windows`);
      E     the ring (:func:`_split_ring`).

    With ``inplace`` the given carry's tensors are written, last, as the
    kernel does.  Returns (carry, the 13 planes)."""
    time = isinstance(carry, GroupedTimeCarry)
    W = int(carry.ring_gid.shape[1])
    P, T = (int(x) for x in gids.shape)
    G = int(carry.fmin_f.shape[1])
    VF, VI = int(carry.ring_f.shape[2]), int(carry.ring_i.shape[2])
    tile = split_tile(P, T, W, G) if tile is None else tile
    out = carry if inplace else type(carry)(*[a.clone() for a in carry])
    ch = _split_chains(carry, vals_f, vals_i, gids, ts, accepted, tile)
    outs = list(_empty_outs(P, T, VF, VI, gids.device))
    if not time or want_forever:
        _split_walk(ch, carry, out, outs, vals_f, vals_i, accepted,
                    want_minmax, want_forever)
    else:                                   # K7b: the carry's extrema
        lane, g = torch.arange(P)[:, None], gids.long()
        for j, name in enumerate(("fmin_f", "fmax_f", "fmin_i", "fmax_i")):
            outs[9 + j][:] = getattr(carry, name)[lane, g]
    if time or (want_minmax and W > 0):
        _split_windows(ch, carry, out, outs, gids, ts, accepted, window_ms,
                       short)
    _split_ring(ch, carry, out)
    return out, tuple(outs)


# ------------------------------------------------------------ CUDA kernels

def _check(fn: str, name: str, t: torch.Tensor, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")


def _carry_shapes(fields: Sequence[str], P, W, G, VF, VI):
    f, i = (P, G, VF), (P, G, VI)
    shape = {"ring_f": (P, W, VF), "ring_i": (P, W, VI), "ring_gid": (P, W),
             "ring_ts": (P, W), "pos": (P,), "cnt": (P,), "overflow": (P,),
             "fsum_hi": f, "fsum_lo": f, "isum_hi": i, "isum_lo": i,
             "gcnt": (P, G), "fmin_f": f, "fmax_f": f, "fmin_i": i,
             "fmax_i": i}
    return [shape[name] for name in fields]


def _ptrs(tensors) -> list:
    return [t.data_ptr() if t is not None else None for t in tensors]


def _launch(entry: str, fn: str, carry, events, dims, inplace: bool):
    """Check, allocate and launch one K7 step (its passes, on the current
    stream): ``events`` are the per-event inputs, the carry comes in and
    a fresh one (or, with ``inplace``, the same tensors) goes out; the
    passes' scratch is ``gagg_scratch_words`` int32 words."""
    import ctypes
    P, T, W, G, VF, VI = dims[:6]
    dev = events[0].device
    cls = type(carry)
    dts = LENGTH_DTYPES if cls is GroupedAggCarry else TIME_DTYPES
    for name, leaf, dt, shape in zip(cls._fields, carry, dts,
                                     _carry_shapes(cls._fields, P, W, G,
                                                   VF, VI)):
        _check(fn, name, leaf, dt, shape, dev)
    out_carry = carry if inplace else cls(*[torch.empty_like(a)
                                            for a in carry])
    outs = _empty_outs(P, T, VF, VI, dev)
    lib = load_kernel("grouped_agg")
    words = lib.gagg_scratch_words(P, T, W, G, VF, VI,
                                   int(cls is GroupedTimeCarry))
    scratch = torch.empty((max(words, 1),), dtype=_I32, device=dev)
    ptrs = (_ptrs(events) + _ptrs(carry) + _ptrs(out_carry) + _ptrs(outs)
            + [scratch.data_ptr()])
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    idims = (ctypes.c_int * len(dims))(*dims)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, entry)(arr, idims, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: launch failed with CUDA error {rc}")
    return out_carry, outs


def grouped_step(window: int, want_minmax: bool, want_forever: bool,
                 numguard: bool = False, inplace: bool = False) -> Callable:
    """The length/running step on the tensors' own device: CPU tensors
    run :func:`grouped_step_plain`; CUDA tensors launch K7a
    (``gagg_step`` in ``csrc/grouped_agg.cu``) on the current stream and
    count the launch in ``grouped_step.launches``.  The kernel writes a
    fresh carry, or with ``inplace`` updates the given one (where the
    JAX package donates it).  Group ids must lie in [0, G) (the
    compiler's do; the kernel indexes the group slabs with them
    unchecked).  A failed build, load or launch raises: there is no
    fallback to the plain step."""
    plain = grouped_step_plain(window, want_minmax, want_forever, numguard)
    fn = "grouped_step"

    def step(carry, vals_f, vals_i, gids, accepted):
        dev = gids.device
        if dev.type == "cpu":
            return plain(carry, vals_f, vals_i, gids, accepted)
        if dev.type != "cuda":
            raise RuntimeError(f"{fn}: no kernel for device {dev}")
        P, T = gids.shape
        G = carry.gcnt.shape[1]
        VF, VI = carry.fsum_hi.shape[2], carry.isum_hi.shape[2]
        _check(fn, "vals_f", vals_f, _F32, (P, T, VF), dev)
        _check(fn, "vals_i", vals_i, _I32, (P, T, VI), dev)
        _check(fn, "gids", gids, _I32, (P, T), dev)
        _check(fn, "accepted", accepted, _BOOL, (P, T), dev)
        nc, outs = _launch(
            "gagg_step", fn, carry, (vals_f, vals_i, gids, accepted),
            (P, T, window, G, VF, VI, int(want_minmax), int(want_forever),
             int(inplace)), inplace)
        grouped_step.launches += 1
        if numguard:
            outs = outs + (sentinel_plane(nc.fsum_hi, nc.isum_hi,
                                          nc.isum_lo, nc.gcnt),)
        return nc, outs

    return step


def grouped_time_step(window_ms: int, capacity: int,
                      want_forever: bool) -> Callable:
    """The time-window step on the tensors' own device: CPU tensors run
    :func:`grouped_time_step_plain`; CUDA tensors launch K7b
    (``gagg_time_step``), which always writes a fresh carry (the
    pre-step carry is what a ring-overflow replay rewinds to), counted
    in ``grouped_time_step.launches``.  No fallback on CUDA."""
    plain = grouped_time_step_plain(window_ms, capacity, want_forever)
    fn = "grouped_time_step"

    def step(carry, vals_f, vals_i, gids, ts, accepted):
        dev = gids.device
        if dev.type == "cpu":
            return plain(carry, vals_f, vals_i, gids, ts, accepted)
        if dev.type != "cuda":
            raise RuntimeError(f"{fn}: no kernel for device {dev}")
        P, T = gids.shape
        G = carry.fmin_f.shape[1]
        VF, VI = carry.fmin_f.shape[2], carry.fmin_i.shape[2]
        if capacity & (capacity - 1):
            raise ValueError(f"{fn}: capacity {capacity} is not a power "
                             f"of two")
        _check(fn, "vals_f", vals_f, _F32, (P, T, VF), dev)
        _check(fn, "vals_i", vals_i, _I32, (P, T, VI), dev)
        _check(fn, "gids", gids, _I32, (P, T), dev)
        _check(fn, "ts", ts, _I32, (P, T), dev)
        _check(fn, "accepted", accepted, _BOOL, (P, T), dev)
        nc, outs = _launch(
            "gagg_time_step", fn, carry,
            (vals_f, vals_i, gids, ts, accepted),
            (P, T, capacity, G, VF, VI, int(window_ms), int(want_forever)),
            False)
        grouped_time_step.launches += 1
        return nc, outs

    return step


#: launches of the CUDA kernels since the last reset (plain runs excluded)
grouped_step.launches = 0
grouped_time_step.launches = 0

