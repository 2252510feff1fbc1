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

from typing import Callable, NamedTuple, Sequence

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
    ``cnt < W``), and the kernels' group lists take it so: a state that
    breaks it raises ``ValueError``."""
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
    """Check, allocate and launch one K7 kernel: ``events`` are the
    per-event inputs, the carry comes in and a fresh one (or, with
    ``inplace``, the same tensors) goes out."""
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
    ptrs = _ptrs(events) + _ptrs(carry) + _ptrs(out_carry) + _ptrs(outs)
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    idims = (ctypes.c_int * len(dims))(*dims)
    lib = load_kernel("grouped_agg")
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

