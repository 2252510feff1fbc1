"""Device selection step (K8): having mask + order-by + limit on egress.

Counterpart of ``siddhi_tpu/ops/select.py:69 build_select_step``, in
PyTorch ops (like the condition programs, K5, it is a program of masks,
gathers and sorts, not a Pallas kernel).  ``build_select_step(program)``
interprets a pure-data plan/select_compiler.SelectProgram into a step
that runs right after the grouped-agg step on the SAME 13 output planes:

  * having atoms compare normalized two-float pairs lexicographically —
    the host's float64 comparison for every operand kind the compiler
    admits;
  * order-by is one stable sort pass per key in reverse spec order,
    descending = reverse the permutation after a stable ascending sort.
    Sort keys are canonicalized first (-0 -> +0, any-NaN pair -> +NaN,
    inf pairs drop their lo residue); XLA's two-key ``lax.sort`` becomes
    two stable ``torch.sort`` passes over int32 order keys (the float
    total order), the minor key first;
  * rows failing ok/having are stably partitioned to the back, then the
    offset rotation and ``out_count = clip(kept - offset, 0, limit)``;
  * the single-f32-key ascending-limit shape (``lax.top_k`` over a
    monotone int32 encoding in the JAX package) is a stable ascending
    sort of the same encoding: ``top_k``'s lower-index-first tie rule is
    a stable sort's, which ``torch.topk`` does not promise.

Outputs: ``(sel_rows [n_pad] i32, meta [2] i32 = [out_count, max_cnt],
*13 planes gathered to [n_pad, (V)] in selection order)``.
"""
from __future__ import annotations

import numpy as np
import torch

from .grouped_agg import _two_sum

# operand plane stems -> index into the 13-tuple grouped-agg output
# (fhi, flo, ihi, ilo, cnt, w_mnf, w_mxf, w_mni, w_mxi,
#  all_mnf, all_mxf, all_mni, all_mxi)
_PLANES = {"wmnf": 5, "wmxf": 6, "wmni": 7, "wmxi": 8,
           "amnf": 9, "amxf": 10, "amni": 11, "amxi": 12}

_I32_MAX = (1 << 31) - 1
_I32 = torch.int32
_F32 = torch.float32


def _int_pair(v):
    """Exact i32 -> normalized two-float32 pair, without the f32-round-
    trip overflow trap at |v| near 2**31: split at 2**16 in integers,
    convert both halves exactly, renormalize with two_sum."""
    up = v >> 16
    low = v - (up << 16)
    hi0 = up.to(_F32) * 65536.0
    lo0 = low.to(_F32)
    return _two_sum(hi0, lo0)


def _const_pair(c: float):
    """Host-side split of a compiler-verified two-float constant."""
    chi = np.float32(c)
    clo = np.float32(np.float64(c) - np.float64(chi))
    return float(chi), float(clo)


def _float_key(x):
    """float32 -> int32 with the float total order of XLA's sort (the
    keys are canonicalized first: no -0.0 and only the positive NaN)."""
    b = x.contiguous().view(_I32)
    return b ^ ((b >> 31) & _I32_MAX)


def _stable_perm(key, perm):
    """``perm`` reordered by a stable ascending sort of ``key[...]``
    (key already gathered by perm)."""
    idx = torch.sort(key, stable=True).indices
    return perm[idx]


def build_select_step(program):
    """Returns step(13 grouped-agg planes [P,T,(V)], lanes, rows, okm)
    -> (sel_rows [n_pad] i32, meta [2] i32, 13 planes compacted to
    [n_pad,(V)] in selection order).  lanes/rows/okm are the padded
    emission gather vectors (padding rows carry okm=False and sort to
    the back, never inside out_count)."""
    having = program.having
    order = program.order
    limit = program.limit
    offset = program.offset

    def step(fhi, flo, ihi, ilo, cnt, w_mnf, w_mxf, w_mni, w_mxi,
             a_mnf, a_mxf, a_mni, a_mxi, lanes, rows, okm):
        planes = (fhi, flo, ihi, ilo, cnt, w_mnf, w_mxf, w_mni, w_mxi,
                  a_mnf, a_mxf, a_mni, a_mxi)
        n = lanes.shape[0]
        dev = lanes.device
        li, ri = lanes.long(), rows.long()
        em = [a[li, ri] for a in planes]

        def operand(o):
            tag = o[0]
            if tag == "const":
                chi, clo = _const_pair(o[1])
                return (torch.full((n,), chi, dtype=_F32, device=dev),
                        torch.full((n,), clo, dtype=_F32, device=dev))
            if tag == "cnt":
                return _int_pair(em[4])
            if tag == "fpair":
                hi = em[0][:, o[1]]
                lo = em[1][:, o[1]]
                # inf sums carry junk/NaN residues; the represented
                # value is the hi inf alone
                lo = torch.where(torch.isinf(hi), torch.zeros_like(lo), lo)
                return hi, lo
            if tag == "f32":
                v = em[_PLANES[o[1]]][:, o[2]]
                return v, torch.zeros_like(v)
            return _int_pair(em[_PLANES[o[1]]][:, o[2]])    # "i32"

        def cmp(op, a, b):
            # lexicographic pair compare == exact f64 compare for
            # normalized pairs; NaN hi makes every ordered compare
            # False, matching host NaN semantics
            (h1, l1), (h2, l2) = a, b
            if op == "lt":
                return (h1 < h2) | ((h1 == h2) & (l1 < l2))
            if op == "gt":
                return (h1 > h2) | ((h1 == h2) & (l1 > l2))
            if op == "le":
                return (h1 < h2) | ((h1 == h2) & (l1 <= l2))
            if op == "ge":
                return (h1 > h2) | ((h1 == h2) & (l1 >= l2))
            eq = (h1 == h2) & (l1 == l2)
            return eq if op == "eq" else ~eq

        def ev(t):
            k = t[0]
            if k == "and":
                return ev(t[1]) & ev(t[2])
            if k == "or":
                return ev(t[1]) | ev(t[2])
            if k == "not":
                return ~ev(t[1])
            return cmp(t[1], operand(t[2]), operand(t[3]))

        keep = okm if having is None else (okm & ev(having))
        max_cnt = torch.where(okm, em[4], torch.zeros_like(em[4])).max()
        kept = keep.sum(dtype=_I32)
        nan = torch.tensor(float("nan"), dtype=_F32, device=dev)
        zero = torch.zeros((), dtype=_F32, device=dev)

        if program.topk and limit is not None and 0 < limit < n:
            # single ascending f32 key: the smallest ``limit`` rows of the
            # monotone i32 encoding, ties lower-index-first
            v, _ = operand(order[0][0])
            v = v + 0.0                                      # -0 -> +0
            v = torch.where(torch.isnan(v), nan, v)
            b = v.contiguous().view(_I32)
            enc = torch.where(b < 0, b ^ _I32_MAX, b)
            enc = torch.where(keep, enc, torch.full_like(enc, _I32_MAX))
            idx = torch.sort(enc, stable=True).indices[:limit]
            perm = torch.cat([idx.to(_I32),
                              torch.zeros((n - limit,), dtype=_I32,
                                          device=dev)])
        else:
            perm = torch.arange(n, dtype=torch.long, device=dev)
            for (o, asc) in reversed(order):
                khi, klo = operand(o)
                kh = khi[perm] + 0.0
                kl = torch.where(torch.isinf(kh), zero, klo[perm]) + 0.0
                isnan = torch.isnan(kh) | torch.isnan(kl)
                kh = torch.where(isnan, nan, kh)
                kl = torch.where(isnan, zero, kl)
                # lax.sort((kh, kl, perm), num_keys=2, is_stable=True):
                # the minor key's stable pass, then the major key's
                step1 = torch.sort(_float_key(kl), stable=True).indices
                step2 = torch.sort(_float_key(kh)[step1],
                                   stable=True).indices
                perm = perm[step1[step2]]
                if not asc:
                    perm = perm.flip(0)
            # stable partition: kept rows first, in current order
            inval = (~keep)[perm].to(_I32)
            perm = _stable_perm(inval, perm)
            if offset:
                perm = torch.cat([perm[offset:], perm[:offset]])
            perm = perm.to(_I32)

        avail = torch.clamp(kept - offset, min=0)
        outc = avail if limit is None else torch.clamp(avail, max=limit)
        meta = torch.stack([outc.to(_I32), max_cnt.to(_I32)])
        pl = perm.long()
        return (perm, meta) + tuple(e[pl] for e in em)

    return step
