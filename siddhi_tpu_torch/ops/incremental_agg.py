"""Incremental-aggregation bucket slabs: the batch fold (K10).

Counterpart of ``siddhi_tpu/ops/incremental_agg.py``.  Each duration's
bucket store is a fixed slab of device tensors

    vals [S, B] float32   one column per decomposed base (sum / sumsq /
                          min / max / last); counts ride the cnt lane
    cnt  [S]    int32     events a slot (shared by 'count' bases)
    comp [S, B] float32   compensated mode only: a TwoSum error lane a
                          column (``@numeric(sum='compensated')``)

folded once per event micro-batch: ``seg [n]`` int32 gives each row's
slot (< 0: the row is masked), ``base_vals [n, B]`` its base values.
A slot's batch partial is folded from the reduction's identity in batch
order, then combined with its slab row: ``cur + add``, or TwoSum of the
two with the error added to ``comp``.

:func:`slab_update_plain` is the PyTorch twin (CPU: ``index_add_`` adds
a slot's rows one at a time in batch order, as the JAX package's
``segment_sum`` does there, so the two agree bit for bit);
:func:`slab_update` the entry: CPU tensors run the twin, CUDA tensors
launch ``iagg_fold`` (``csrc/iagg_fold.cu``), which sorts the rows by
slot stably and folds each slot's rows in batch order (one thread a
slot, a warp for a long run), so it equals the twin bit for bit (NaN
sums compared by position: the card writes its canonical NaN).  torch's CUDA ``index_add_`` adds with
atomics, in an order that changes from run to run: the kernel does not.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ._kernels import load_kernel
from .grouped_agg import (_check, _fmax, _fmin, _from_order_key,
                          _order_key, _two_sum)

NEG_INF = np.float32(-np.inf)
POS_INF = np.float32(np.inf)

#: base function -> the kernel's code (csrc/iagg_fold.cu Fn)
FN_CODES = {"sum": 0, "sumsq": 1, "min": 2, "max": 3, "count": 4, "last": 5}
#: most base columns a slab may have on the kernel (its parameter block)
MAX_BASES = 32

_F32, _I32 = torch.float32, torch.int32


def init_row(base_fns: Sequence[str]) -> np.ndarray:
    """Initial slab row: identity of each base's reduction."""
    out = np.zeros(len(base_fns), np.float32)
    for i, fn in enumerate(base_fns):
        if fn == "min":
            out[i] = POS_INF
        elif fn == "max":
            out[i] = NEG_INF
    return out


def _segment_extreme(col, seg_c, S: int, smallest: bool):
    """segment_min (or max) of ``col`` into S + 1 segments from the
    identity (+inf or -inf): IEEE, so the order of the rows does not
    matter (NaN propagates, -0.0 < +0.0)."""
    ident = float("inf") if smallest else float("-inf")
    init = _order_key(torch.full((S + 1,), ident, dtype=_F32,
                                 device=col.device))
    red = init.scatter_reduce(0, seg_c, _order_key(col),
                              "amin" if smallest else "amax")
    nan = torch.zeros((S + 1,), dtype=_I32, device=col.device).index_add_(
        0, seg_c, torch.isnan(col).to(_I32))
    r = _from_order_key(red)
    return torch.where(nan > 0, torch.full_like(r, float("nan")), r)[:S]


def slab_update_plain(base_fns: Sequence[str], vals, cnt, seg, base_vals,
                      comp=None):
    """The torch twin of the JAX package's ``build_slab_update`` fold:
    (vals, cnt), or with ``comp`` (compensated mode) (vals, comp, cnt),
    as new tensors.  Rows with ``seg < 0`` (or ``>= S``) are masked."""
    S = vals.shape[0]
    n = seg.shape[0]
    if n == 0:
        return (vals, cnt) if comp is None else (vals, comp, cnt)
    dev = vals.device
    seg = seg.to(torch.int64)
    valid = (seg >= 0) & (seg < S)
    seg_c = torch.where(valid, seg, torch.full_like(seg, S))
    cnt = cnt + torch.zeros((S + 1,), dtype=_I32, device=dev).index_add_(
        0, seg_c, valid.to(_I32))[:S]
    cols, ccols = [], []
    for b, fn in enumerate(base_fns):
        col = base_vals[:, b]
        cur = vals[:, b]
        if fn in ("sum", "sumsq"):
            v = col * col if fn == "sumsq" else col
            add = torch.zeros((S + 1,), dtype=_F32, device=dev).index_add_(
                0, seg_c, torch.where(valid, v, torch.zeros_like(v)))[:S]
            if comp is not None:
                s, err = _two_sum(cur, add)
                ccols.append(comp[:, b] + err)
                cols.append(s)
            else:
                cols.append(cur + add)
        elif fn == "min":
            cols.append(_fmin(cur, _segment_extreme(col, seg_c, S, True)))
        elif fn == "max":
            cols.append(_fmax(cur, _segment_extreme(col, seg_c, S, False)))
        elif fn == "count":
            cols.append(cur)         # counts ride the dedicated cnt lane
        elif fn == "last":
            # batch-order last event per slot wins
            idx = torch.where(valid, torch.arange(n, device=dev),
                              torch.full_like(seg, -1))
            li = torch.full((S + 1,), -1, dtype=torch.int64,
                            device=dev).scatter_reduce(
                0, seg_c, idx, "amax")[:S]
            lastv = col[li.clamp(0, n - 1)]
            cols.append(torch.where(li >= 0, lastv, cur))
        else:
            raise ValueError(f"Unknown base fn {fn}")
        if comp is not None and fn not in ("sum", "sumsq"):
            ccols.append(comp[:, b])   # untouched for non-sum lanes
    new_vals = torch.stack(cols, dim=1)
    if comp is not None:
        return new_vals, torch.stack(ccols, dim=1), cnt
    return new_vals, cnt


def reset_slots_plain(vals, cnt, slots, base_fns: Sequence[str]):
    """Reset slots to their reductions' identities (the JAX package's
    ``reset_slots``); new tensors.  Neither package's runtime calls it:
    a purge rebuilds the slabs."""
    vals = vals.clone()
    cnt = cnt.clone()
    slots = slots.to(torch.int64)
    vals[slots] = torch.as_tensor(init_row(base_fns), device=vals.device)
    cnt[slots] = 0
    return vals, cnt


# ------------------------------------------------------------ CUDA kernel

def slab_update(base_fns: Sequence[str], vals, cnt, seg, base_vals,
                comp=None):
    """The fold on the tensors' own device: CPU tensors run
    :func:`slab_update_plain`; CUDA tensors launch ``iagg_fold`` on the
    current stream, updating ``vals``, ``cnt`` (and ``comp``) in place
    (where the JAX package donates them), and count the launch in
    ``slab_update.launches``.  Returns what the twin returns.  A failed
    build, load or launch raises: there is no fallback to the twin."""
    dev = vals.device
    if dev.type == "cpu":
        return slab_update_plain(base_fns, vals, cnt, seg, base_vals, comp)
    if dev.type != "cuda":
        raise RuntimeError(f"slab_update: no kernel for device {dev}")
    import ctypes
    fn = "slab_update"
    S, B = vals.shape
    n = seg.shape[0]
    if len(base_fns) != B or B > MAX_BASES:
        raise ValueError(f"{fn}: {len(base_fns)} bases for {B} columns "
                         f"(the kernel takes at most {MAX_BASES})")
    codes = [FN_CODES[b] for b in base_fns]
    _check(fn, "vals", vals, _F32, (S, B), dev)
    _check(fn, "cnt", cnt, _I32, (S,), dev)
    _check(fn, "seg", seg, _I32, (n,), dev)
    _check(fn, "base_vals", base_vals, _F32, (n, B), dev)
    if comp is not None:
        _check(fn, "comp", comp, _F32, (S, B), dev)
    out = (vals, cnt) if comp is None else (vals, comp, cnt)
    if n == 0:
        return out
    lib = load_kernel("iagg_fold")
    nbytes = lib.iagg_scratch_bytes(n, S)
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    fns = (ctypes.c_int * B)(*codes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.iagg_fold(base_vals.data_ptr(), seg.data_ptr(),
                       vals.data_ptr(),
                       comp.data_ptr() if comp is not None else None,
                       cnt.data_ptr(), fns, n, S, B, scratch.data_ptr(),
                       nbytes, stream)
    if rc != 0:
        raise RuntimeError(f"iagg_fold: launch failed with CUDA error {rc}")
    slab_update.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (twin runs excluded)
slab_update.launches = 0
