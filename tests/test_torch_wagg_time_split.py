"""K6's passes (``time_split_model``, the CPU model of csrc/wagg_time.cu)
against the plain twin ``time_wagg_step_plain``.

The model computes each event's ring by the closed form the kernel uses
(slot s holds X[A_t + ((s - pos0 - A_t) mod C)], X the lane's entries in
write order) and asserts that every leaf lies in the window its CTA of
events copies to shared memory.  Over chained blocks, bit for bit on
every output plane and every carry leaf (NaN positions compared): T >= C
and T < C, C not a power of two, pos wrapping, an overflow mid-block
grown and replayed, out-of-order timestamps, a ±inf/NaN/-0.0 feed,
rejected rows and an all-rejected block; with min/max on and off, at the
kernel's chunk of events and at a chunk of 3 (many CTAs a lane).
"""
import numpy as np
import pytest
import torch

from siddhi_tpu_torch.ops.windowed_agg import (TIME_CHUNK, TS_EMPTY,
                                               TimeWaggCarry,
                                               make_time_wagg_carry,
                                               time_split_model,
                                               time_wagg_step_plain)

#: name: (P, T, C, window ms, feed, blocks)
CASES = {
    "t_ge_c": (3, 40, 16, 60, "uniform", 4),
    "t_lt_c": (3, 10, 64, 200, "uniform", 5),
    "c_not_pow2": (2, 30, 37, 150, "uniform", 4),
    "c_small_not_pow2": (2, 9, 3, 40, "uniform", 5),
    "overflow_mid_block": (2, 50, 4, 1000, "uniform", 3),
    "out_of_order": (3, 24, 20, 80, "out_of_order", 4),
    "nonfinite": (3, 32, 24, 100, "nonfinite", 4),
    "rejected": (3, 30, 16, 100, "rejected", 4),
    "all_rejected": (2, 12, 8, 100, "none", 3),
    "c_one": (2, 7, 1, 50, "uniform", 3),
}


def _feed(rng, P, T, kind, t0):
    v = rng.uniform(-10, 10, (P, T)).astype(np.float32)
    if kind == "nonfinite":
        m = rng.random((P, T))
        v[m < 0.05] = np.inf
        v[(m >= 0.05) & (m < 0.08)] = -np.inf
        v[(m >= 0.08) & (m < 0.11)] = np.nan
        v[(m >= 0.11) & (m < 0.3)] = -0.0
        v[(m >= 0.3) & (m < 0.4)] = 0.0
    ts = t0 + np.cumsum(rng.integers(0, 12, (P, T)), axis=1)
    if kind == "out_of_order":
        ts = t0 + rng.integers(0, 150, (P, T))
    dens = {"rejected": 0.4, "none": 0.0}.get(kind, 0.85)
    ok = rng.random((P, T)) < dens
    return (torch.from_numpy(v), torch.from_numpy(ts.astype(np.int32)),
            torch.from_numpy(ok), int(ts.max()))


def _grow(carry, new_c):
    """The compiler's grow: entries kept in ts order (stable), empty
    slots dropped, pos = cnt."""
    ring, rts = carry.ring.numpy(), carry.ring_ts.numpy()
    P = ring.shape[0]
    nr = np.zeros((P, new_c), np.float32)
    nts = np.full((P, new_c), TS_EMPTY, np.int32)
    cnt = np.zeros(P, np.int32)
    for p in range(P):
        order = np.argsort(rts[p], kind="stable")
        sel = order[rts[p, order] != TS_EMPTY]
        nr[p, :len(sel)] = ring[p, sel]
        nts[p, :len(sel)] = rts[p, sel]
        cnt[p] = len(sel)
    return TimeWaggCarry(torch.from_numpy(nr), torch.from_numpy(nts),
                         torch.from_numpy(cnt % new_c),
                         torch.from_numpy(cnt), carry.last_ts.clone(),
                         torch.zeros(P, dtype=torch.bool))


def _same(a, b) -> bool:
    a, b = a.numpy(), b.numpy()
    if a.dtype == np.float32:
        na, nb = np.isnan(a), np.isnan(b)
        return bool(np.array_equal(na, nb) and np.array_equal(
            a.view(np.int32)[~na], b.view(np.int32)[~nb]))
    return bool(np.array_equal(a, b))


@pytest.mark.parametrize("chunk", [TIME_CHUNK, 3])
@pytest.mark.parametrize("minmax", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_model_equals_plain(name, minmax, chunk):
    P, T, C, span, feed, blocks = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 7 * int(minmax))
    cm = make_time_wagg_carry(P, C, "cpu")
    cp = make_time_wagg_carry(P, C, "cpu")
    t0, replays, wrapped = 0, 0, False
    with np.errstate(all="ignore"):
        for bi in range(blocks):
            v, ts, ok, t0 = _feed(rng, P, T, feed, t0)
            while True:
                nm, om = time_split_model(span, cm, v, ts, ok, minmax,
                                          chunk=chunk)
                np_, op = time_wagg_step_plain(span, cp, v, ts, ok, minmax)
                where = f"{name} block {bi} C={cm.ring.shape[1]}"
                assert len(om) == len(op)
                for k, (a, b) in enumerate(zip(om, op)):
                    assert _same(a, b), f"{where}: output {k}"
                for field, a, b in zip(TimeWaggCarry._fields, nm, np_):
                    assert _same(a, b), f"{where}: carry {field}"
                if not bool(np_.overflow.any()):
                    break
                replays += 1
                c2 = cm.ring.shape[1] * 2
                cm, cp = _grow(cm, c2), _grow(cp, c2)
            wrapped |= bool((np_.pos < cp.pos).any())
            cm, cp = nm, np_
    if name == "overflow_mid_block":
        assert replays
    if name in ("t_ge_c", "c_not_pow2", "c_small_not_pow2"):
        assert wrapped


def test_split_model_empty_block():
    """T = 0: no output, the carry passes through."""
    carry = make_time_wagg_carry(2, 5, "cpu")
    v, ts, ok, _ = _feed(np.random.default_rng(3), 2, 9, "uniform", 0)
    carry, _ = time_wagg_step_plain(100, carry, v, ts, ok, True)
    empty = (torch.zeros((2, 0)), torch.zeros((2, 0), dtype=torch.int32),
             torch.zeros((2, 0), dtype=torch.bool))
    nm, om = time_split_model(100, carry, *empty, True)
    np_, op = time_wagg_step_plain(100, carry, *empty, True)
    for a, b in list(zip(om, op)) + list(zip(nm, np_)):
        assert _same(a, b)
