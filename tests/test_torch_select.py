"""The selection step (K8): JAX package vs torch port, bit for bit.

``siddhi_tpu/ops/select.py build_select_step`` (a jitted program of
masks, gathers and sorts) and ``siddhi_tpu_torch/ops/select.py`` run the
same SelectProgram over the same 13 grouped-agg planes, made from a seed
with numpy: ties, NaN, -0.0/+0.0, ±inf, int32 extremes, offsets, limits,
descending and two-key orders, and the single-key ``top_k`` shape.  The
permutation, the meta pair and every gathered plane must be equal
(tolerance 0; NaN payloads aside).
"""
import numpy as np
import pytest
import torch

from siddhi_tpu.ops.select import build_select_step as jax_select
from siddhi_tpu.plan.select_compiler import SelectProgram
from siddhi_tpu_torch.ops.select import build_select_step as torch_select

P, T, VF, VI = 3, 16, 2, 2


def _planes(seed: int, ties: bool):
    rng = np.random.default_rng(seed)

    def f(shape, lo=-5.0, hi=5.0):
        v = rng.uniform(lo, hi, shape).astype(np.float32)
        if ties:
            v = np.round(v).astype(np.float32)
        r = rng.random(shape)
        v[r < 0.05] = np.nan
        v[(r >= 0.05) & (r < 0.1)] = np.inf
        v[(r >= 0.1) & (r < 0.13)] = -np.inf
        v[(r >= 0.13) & (r < 0.2)] = -0.0
        v[(r >= 0.2) & (r < 0.27)] = 0.0
        return v

    def i(shape):
        v = rng.integers(-4, 5, shape).astype(np.int32)
        r = rng.random(shape)
        v[r < 0.05] = np.iinfo(np.int32).max
        v[r > 0.95] = np.iinfo(np.int32).min + 1
        return v

    fhi = f((P, T, VF))
    flo = (f((P, T, VF)) * np.float32(1e-9)).astype(np.float32)
    cnt = rng.integers(0, 6, (P, T)).astype(np.int32)
    planes = (fhi, flo, i((P, T, VI)), i((P, T, VI)), cnt,
              f((P, T, VF)), f((P, T, VF)), i((P, T, VI)), i((P, T, VI)),
              f((P, T, VF)), f((P, T, VF)), i((P, T, VI)), i((P, T, VI)))
    n = 24
    n_pad = 32
    lanes = np.zeros(n_pad, np.int32)
    rows = np.zeros(n_pad, np.int32)
    okm = np.zeros(n_pad, bool)
    lanes[:n] = rng.integers(0, P, n)
    rows[:n] = rng.integers(0, T, n)
    okm[:n] = rng.random(n) < 0.85
    return planes + (lanes, rows, okm)


def _prog(having=None, order=(), limit=None, offset=0, topk=False):
    return SelectProgram(having=having, order=tuple(order), limit=limit,
                         offset=offset, topk=topk, uses_minmax=False,
                         uses_forever=False, has_agg=True, key="t")


FP0 = ("fpair", 0)
FP1 = ("fpair", 1)
CNT = ("cnt",)
MNF = ("f32", "wmnf", 0)
MXI = ("i32", "wmxi", 1)
AMNI = ("i32", "amni", 0)
PROGRAMS = {
    "having_gt": _prog(having=("cmp", "gt", FP0, ("const", 1.5))),
    "having_and_or": _prog(having=("or", ("and",
                                          ("cmp", "ge", CNT, ("const", 2.0)),
                                          ("cmp", "lt", MNF, ("const", 0.0))),
                                   ("not", ("cmp", "eq", MXI, AMNI))),
                           order=[(FP0, True)]),
    "having_ne_le": _prog(having=("and", ("cmp", "ne", FP1, FP0),
                                  ("cmp", "le", CNT, ("const", 4.0)))),
    "order_desc": _prog(order=[(FP0, False)]),
    "order_two_keys": _prog(order=[(CNT, True), (MNF, False)]),
    "order_int_desc_limit": _prog(order=[(MXI, False)], limit=5),
    "offset_limit": _prog(having=("cmp", "gt", CNT, ("const", 0.0)),
                          order=[(FP1, True)], limit=4, offset=3),
    "offset_only": _prog(order=[(AMNI, True)], offset=2),
    "limit_only": _prog(limit=7),
    "topk": _prog(order=[(MNF, True)], limit=6, topk=True),
    "topk_having": _prog(having=("cmp", "ge", CNT, ("const", 2.0)),
                         order=[(MNF, True)], limit=3, topk=True),
    "topk_limit_above_n": _prog(order=[(MNF, True)], limit=64, topk=True),
}


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        na, nb = np.isnan(a), np.isnan(b)
        return bool((na == nb).all() and
                    (a.view(np.int32)[~na] == b.view(np.int32)[~nb]).all())
    return bool((a == b).all())


@pytest.mark.parametrize("ties", [False, True], ids=["spread", "ties"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_select_step_equals_jax(name, ties):
    prog = PROGRAMS[name]
    args = _planes(sum(map(ord, name)) + int(ties), ties)
    want = jax_select(prog)(*args)
    got = torch_select(prog)(*[torch.from_numpy(np.ascontiguousarray(a))
                               for a in args])
    assert len(got) == len(want) == 15
    for k, (w, g) in enumerate(zip(want, got)):
        assert _same(np.asarray(w), g.numpy()), (name, k)
