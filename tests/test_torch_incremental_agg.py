"""Incremental aggregation (K10): JAX package vs torch port.

- ``slab_update_plain`` against the JAX package's ``build_slab_update``
  on the CPU, bit for bit (NaN payloads included): both fold a slot's
  rows in batch order from the identity.  Both modes, each base alone
  and all six, masked rows, NaN/+-inf/+-0.0 in the feed and the slab,
  one slot holding the batch, S at the radix sort's digit boundaries.
- ``reset_slots_plain`` against ``reset_slots``.
- The public API: the same ``define aggregation`` app through the JAX
  package's default engine and the port's (``device="cpu"``, the twin):
  both on ``DeviceAggregationRuntime``, query rows equal; a JAX snapshot
  restored into the port goes on equal; purge; compensated sums past
  2^24 exact.
- Without CUDA the port's default device raises for an aggregation app
  (no host fallback).
"""
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu.ops.incremental_agg as J
import siddhi_tpu_torch
import siddhi_tpu_torch.ops.incremental_agg as T

FNS = ("sum", "sumsq", "min", "max", "count", "last")
SPECIAL = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)


def _same(a, b, nan_bits=True) -> bool:
    """Equal bit for bit; with ``nan_bits`` False a NaN matches a NaN
    whatever its payload."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        eq = a.view(np.int32) == b.view(np.int32)
        if not nan_bits:
            eq |= np.isnan(a) & np.isnan(b)
        return bool(eq.all())
    return bool((a == b).all())


def _inputs(rng, fns, n, S, seg_kind, special):
    B = len(fns)
    vals = np.tile(J.init_row(fns), (S, 1))
    vals[:S // 2] = rng.standard_normal((S // 2, B)).astype(np.float32)
    comp = (rng.standard_normal((S, B)) * 1e-6).astype(np.float32)
    cnt = rng.integers(0, 100, S).astype(np.int32)
    cnt[0] = np.int32(2**31 - 3)                  # the count lane wraps
    if seg_kind == "one":
        seg = np.full(n, S // 2, np.int32)
    else:
        seg = rng.integers(-2, S, n).astype(np.int32)
        if seg_kind == "masked":
            seg[rng.random(n) < 0.9] = -1
    bv = (rng.standard_normal((n, B)) * 100).astype(np.float32)
    if special:
        for a in (bv, vals, comp):
            m = rng.random(a.shape) < 0.03
            a[m] = rng.choice(SPECIAL, int(m.sum()))
    return vals, cnt, comp, seg, bv


CASES = ([(fn,) for fn in FNS] + [FNS])
#: slab sizes at K10's digit boundaries
_DIGIT_S = (255, 256, 65_535, 65_536, 1 << 20)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("seg_kind,n,S", [
    ("uniform", 1, 8), ("uniform", 700, 64), ("masked", 4000, 512),
    ("one", 5000, 16), ("uniform", 20_000, 37),
    # S at the 8-bit digit boundaries of K10's radix sort (keys lie in
    # [0, S]: one pass to 255, two to 65,535, three past); NaN compared by
    # position there (_DIGIT_S)
    ("uniform", 300, 255), ("masked", 600, 256), ("uniform", 700, 65_535),
    ("masked", 800, 65_536), ("uniform", 1000, 1 << 20)])
@pytest.mark.parametrize("fns", CASES, ids=lambda f: "+".join(f))
def test_slab_update_plain_equals_jax(fns, seg_kind, n, S, compensated):
    # Where both addends of a compensated error lane are NaN (comp NaN, cur
    # +-inf), XLA's fused program keeps either operand's payload, by how it
    # fuses (it differs between programs), and torch's kernel the second's:
    # the digit-boundary slabs hold hundreds of such cells, so they compare
    # NaN by position, as K10's contract does on the card
    nan_bits = S not in _DIGIT_S
    rng = np.random.default_rng(len(fns) * 1000 + n + S)
    vals, cnt, comp, seg, bv = _inputs(rng, fns, n, S, seg_kind,
                                       special=True)
    upd = J.build_slab_update(fns, compensated=compensated)
    args = [vals] + ([comp] if compensated else []) + [cnt, seg, bv]
    want = upd(*[np.array(a) for a in args])
    got = T.slab_update_plain(fns, *[torch.from_numpy(a) for a in
                                     (vals, cnt, seg, bv)],
                              torch.from_numpy(comp) if compensated
                              else None)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert _same(w, g.numpy(), nan_bits)
    # the entry takes CPU tensors to the twin
    again = T.slab_update(fns, *[torch.from_numpy(a) for a in
                                 (vals, cnt, seg, bv)],
                          torch.from_numpy(comp) if compensated else None)
    for w, g in zip(want, again):
        assert _same(w, g.numpy(), nan_bits)


def test_compensated_twin_exact_past_2_24():
    """Integer-valued increments on a 2^25 sum: the error lane keeps
    them, as the JAX package's does."""
    fns = ("sum", "count")
    vals = np.full((4, 2), float(1 << 25), np.float32)
    comp = np.zeros_like(vals)
    cnt = np.zeros(4, np.int32)
    upd = J.build_slab_update(fns, compensated=True)
    tv, tc, tn = (torch.from_numpy(vals), torch.from_numpy(comp),
                  torch.from_numpy(cnt))
    jv, jc, jn = vals, comp, cnt
    rng = np.random.default_rng(5)
    total = 0
    for _ in range(5):
        seg = np.zeros(3000, np.int32)
        bv = rng.integers(1, 9, (3000, 2)).astype(np.float32)
        total += int(bv[:, 0].sum())
        jv, jc, jn = upd(np.array(jv), np.array(jc), np.array(jn), seg, bv)
        tv, tc, tn = T.slab_update_plain(fns, tv, tn, torch.from_numpy(seg),
                                         torch.from_numpy(bv), tc)
        for w, g in zip((jv, jc, jn), (tv, tc, tn)):
            assert _same(w, g.numpy())
    assert np.float64(tv[0, 0]) + np.float64(tc[0, 0]) == (1 << 25) + total


def test_reset_slots_plain_equals_jax():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((32, len(FNS))).astype(np.float32)
    cnt = rng.integers(0, 50, 32).astype(np.int32)
    slots = np.asarray([0, 5, 31, 7], np.int32)
    wv, wc = J.reset_slots(np.array(vals), np.array(cnt), slots, FNS)
    gv, gc = T.reset_slots_plain(torch.from_numpy(vals),
                                 torch.from_numpy(cnt),
                                 torch.from_numpy(slots), FNS)
    assert _same(wv, gv.numpy()) and _same(wc, gc.numpy())


# ------------------------------------------------------------ public API

APP = """
define stream S (symbol string, price double, volume long, ts long);
{anno}define aggregation Agg
from S
select symbol, avg(price) as avgPrice, sum(price) as total,
       count() as n, min(price) as lo, max(price) as hi
group by symbol
aggregate by ts every sec ... hour;
"""

Q = """
from Agg within 1496200000000, 1496400000000 per '{per}'
select AGG_TIMESTAMP, symbol, avgPrice, total, n, lo, hi
"""


def _manager(pkg):
    return (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
            else pkg.SiddhiManager())


def _sends(seed, n, base=1_496_289_950_000):
    rng = np.random.default_rng(seed)
    syms = ["A", "B", "C", "D"]
    return {"symbol": np.asarray([syms[i] for i in
                                  rng.integers(0, 4, n)], object),
            "price": rng.uniform(1.0, 100.0, n),
            "volume": rng.integers(1, 5, n),
            "ts": base + rng.integers(0, 180_000, n)}


def _rows(rt, per="seconds"):
    return sorted([tuple(e.data) for e in rt.query(Q.format(per=per))],
                  key=lambda r: (r[0], r[1]))


def _start(pkg, anno=""):
    rt = _manager(pkg).create_siddhi_app_runtime(APP.format(anno=anno))
    rt.start()
    agg = rt.aggregations["Agg"]
    assert type(agg).__name__ == "DeviceAggregationRuntime"
    return rt


def test_query_rows_equal_jax():
    rts = [_start(pkg) for pkg in (siddhi_tpu, siddhi_tpu_torch)]
    try:
        for i in range(3):
            cols = _sends(i, 500)
            for rt in rts:
                rt.get_input_handler("S").send_batch(cols)
        for per in ("seconds", "minutes", "hours"):
            want, got = (_rows(rt, per) for rt in rts)
            assert want and want == got
    finally:
        for rt in rts:
            rt.shutdown()


def test_jax_snapshot_restores_into_port():
    jrt = _start(siddhi_tpu)
    trt = _start(siddhi_tpu_torch)
    try:
        h = jrt.get_input_handler("S")
        h.send_batch(_sends(7, 400))
        state = jrt.aggregations["Agg"].current_state()
        trt.aggregations["Agg"].restore_state(state)
        assert _rows(trt) == _rows(jrt)
        for rt in (jrt, trt):
            rt.get_input_handler("S").send_batch(_sends(8, 400))
        assert _rows(trt) == _rows(jrt)
        # and the port's snapshot back into the JAX package
        jrt2 = _start(siddhi_tpu)
        try:
            jrt2.aggregations["Agg"].restore_state(
                trt.aggregations["Agg"].current_state())
            assert _rows(jrt2) == _rows(trt)
        finally:
            jrt2.shutdown()
    finally:
        jrt.shutdown()
        trt.shutdown()


def test_purge_equal_jax():
    rts = [_start(pkg) for pkg in (siddhi_tpu, siddhi_tpu_torch)]
    try:
        for rt in rts:
            rt.get_input_handler("S").send_batch(_sends(11, 600))
        left = []
        for rt in rts:
            agg = rt.aggregations["Agg"]
            agg._sync()
            newest = max(b for b, _ in agg.buckets["sec"])
            agg.purge(newest + 10_000_000_000)
            agg._sync()
            left.append({d: len(agg.buckets[d]) for d in agg.durations})
            rt.get_input_handler("S").send_batch(_sends(12, 300))
        assert left[0] == left[1]
        assert _rows(rts[0]) == _rows(rts[1])
    finally:
        for rt in rts:
            rt.shutdown()


def test_compensated_past_2_24_equal_jax():
    anno = "@numeric(sum='compensated')\n"
    rts = [_start(pkg, anno) for pkg in (siddhi_tpu, siddhi_tpu_torch)]
    try:
        base = 1_496_289_950_000
        for rt in rts:
            assert rt.aggregations["Agg"]._compensated is True
            h = rt.get_input_handler("S")
            h.send(["A", float(1 << 25), 1, base])
            h.send_batch({"symbol": np.full(300, "A", object),
                          "price": np.ones(300), "volume":
                          np.ones(300, np.int64),
                          "ts": base + 1 + np.arange(300)})
        want, got = (_rows(rt, "hours") for rt in rts)
        assert want == got
        assert got[0][3] == float(1 << 25) + 300.0
    finally:
        for rt in rts:
            rt.shutdown()


def test_without_cuda_an_aggregation_app_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        siddhi_tpu_torch.SiddhiManager().create_siddhi_app_runtime(
            APP.format(anno=""))
