"""The time-window aggregation step (K6) and its compiler: JAX vs port.

- ``time_wagg_step_plain`` (the torch twin of ``csrc/wagg_time.cu``)
  against the JAX package's ``build_time_wagg_step`` on chained blocks:
  counts, min, max and every carry leaf (ring, ring_ts, pos, cnt,
  last_ts, overflow) bit for bit (NaN as NaN); sums within 1e-6 of the
  window's sum of magnitudes (the twin sums by the kernel's pairwise
  tree, XLA by its own order) and exact on integer-valued feeds.  The
  feeds cover ring overflow, out-of-order timestamps, a ±inf/NaN/-0.0
  feed and rejected rows.
- Torch copies of the JAX suite's naive-reference cases that call jax
  themselves (``tests/test_tpu_wagg.py``).
- ``CompiledWindowedAgg`` time/externalTime end to end against the JAX
  one, through ring growth by replay, and a JAX time-wagg state (compiler
  and partitioned runtime) restored into the port.
"""
import jax
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.ops.windowed_agg import build_time_wagg_step
from siddhi_tpu.ops.windowed_agg import \
    make_time_wagg_carry as jax_make_time_carry
from siddhi_tpu.plan import wagg_compiler as jwc
from siddhi_tpu_torch.ops.pack import pack_blocks
from siddhi_tpu_torch.ops.windowed_agg import (make_time_wagg_carry,
                                               make_wagg_carry,
                                               pair_tree_sum,
                                               time_wagg_step_plain,
                                               wagg_step_plain)
from siddhi_tpu_torch.plan import wagg_compiler as pwc


def _feed(seed, P, T, kind):
    """(values, ts offsets, accepted) blocks of one kind of feed."""
    rng = np.random.default_rng(seed)
    t0 = 0
    while True:
        if kind == "integer":
            v = rng.integers(0, 50, (P, T)).astype(np.float32)
        else:
            v = rng.uniform(0.0, 10.0, (P, T)).astype(np.float32)
        if kind == "nonfinite":
            m = rng.random((P, T))
            v[m < 0.05] = np.inf
            v[(m >= 0.05) & (m < 0.08)] = -np.inf
            v[(m >= 0.08) & (m < 0.1)] = np.nan
            v[(m >= 0.1) & (m < 0.3)] = -0.0
        ts = t0 + np.cumsum(rng.integers(0, 20, (P, T)), axis=1)
        if kind == "out_of_order":
            ts = t0 + rng.integers(0, 400, (P, T))
        t0 = int(ts.max())
        ok = rng.random((P, T)) < (0.5 if kind == "rejected" else 0.85)
        yield v, ts.astype(np.int32), ok


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        na, nb = np.isnan(a), np.isnan(b)
        return np.array_equal(na, nb) and \
            np.array_equal(a.view(np.int32)[~na], b.view(np.int32)[~nb])
    return np.array_equal(a, b)


def _sums_close(js, ts_, mags, exact):
    js, ts_ = np.asarray(js, np.float64), np.asarray(ts_, np.float64)
    fin = np.isfinite(js)
    assert np.array_equal(fin, np.isfinite(ts_))
    assert _same_bits(np.asarray(js, np.float32)[~fin],
                      np.asarray(ts_, np.float32)[~fin])
    if exact:
        assert np.array_equal(js[fin], ts_[fin])
    else:
        assert (np.abs(js[fin] - ts_[fin]) <= 1e-6 * mags[fin]).all()


@pytest.mark.parametrize("kind", ["uniform", "integer", "overflow",
                                  "out_of_order", "nonfinite", "rejected"])
def test_plain_equals_jax(kind):
    P, T, C, span = 4, 48, 16, 60
    if kind == "overflow":
        C, span = 6, 1000
    step = jax.jit(build_time_wagg_step(span, C, want_minmax=True))
    cj = jax_make_time_carry(P, C)
    ct = make_time_wagg_carry(P, C, "cpu")
    feed = _feed(sum(map(ord, kind)), P, T, kind)
    overflowed = False
    for _ in range(3):
        v, ts, ok = next(feed)
        cj, oj = step(cj, v, ts, ok)
        ct, ot = time_wagg_step_plain(span, ct, torch.from_numpy(v),
                                      torch.from_numpy(ts),
                                      torch.from_numpy(ok), True)
        for name, a, b in zip(ct._fields, cj, ct):
            assert _same_bits(a, b.numpy()), name
        for i in (1, 2, 3):
            assert _same_bits(oj[i], ot[i].numpy()), i
        # count x |max| bounds the window's sum of magnitudes (values
        # are >= 0), which bounds the summation order's difference
        n = ot[1].numpy()
        mags = np.where(n > 0, np.abs(np.where(
            n > 0, ot[3].numpy(), 0).astype(np.float64)) * n, 0.0)
        _sums_close(oj[0], ot[0].numpy(), mags, kind == "integer")
        overflowed |= bool(np.asarray(cj.overflow).any())
    if kind == "overflow":
        assert overflowed


def test_pair_tree_sum_order():
    """Adjacent pairs, level by level, padded with +0.0 to a power of
    two: (((a+b)+(c+d))+((e+0)+(0+0)))."""
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0, 3.0]], dtype=torch.float32)
    a, b, c, d, e = (np.float32(v) for v in (1e8, 1.0, -1e8, 1.0, 3.0))
    want = ((a + b) + (c + d)) + ((e + np.float32(0)) + np.float32(0))
    assert pair_tree_sum(x).item() == want
    z = torch.tensor([[-0.0, -0.0]], dtype=torch.float32)
    assert torch.signbit(pair_tree_sum(z)).item()


def _naive_time_window(vals, ts, span_ms, accepted):
    hist, results = [], []
    for v, t, ok in zip(vals, ts, accepted):
        if not ok:
            results.append(None)
            continue
        hist.append((t, v))
        hist = [(tt, vv) for tt, vv in hist if tt > t - span_ms]
        vs = [vv for _, vv in hist]
        results.append((sum(vs), len(vs), min(vs), max(vs)))
    return results


def test_time_wagg_kernel_matches_naive():
    """Torch copy of tests/test_tpu_wagg.py's case of the same name."""
    P, T, W, SPAN = 4, 128, 16, 50
    rng = np.random.default_rng(9)
    values = rng.uniform(0, 10, (P, T)).astype(np.float32)
    ts = np.cumsum(rng.integers(1, 20, (P, T)), axis=1).astype(np.int32)
    accepted = rng.random((P, T)) < 0.8
    carry, (s, c, mn, mx) = time_wagg_step_plain(
        SPAN, make_time_wagg_carry(P, W, "cpu"), torch.from_numpy(values),
        torch.from_numpy(ts), torch.from_numpy(accepted), True)
    assert not carry.overflow.any()
    for p in range(P):
        ref = _naive_time_window(values[p], ts[p], SPAN, accepted[p])
        for t in range(T):
            if ref[t] is None:
                continue
            rs, rc, rmn, rmx = ref[t]
            assert c[p, t] == rc, (p, t)
            assert s[p, t].item() == pytest.approx(rs, rel=1e-5), (p, t)
            assert mn[p, t].item() == pytest.approx(rmn), (p, t)
            assert mx[p, t].item() == pytest.approx(rmx), (p, t)


def test_wagg_minmax_matches_naive():
    """Torch copy of tests/test_tpu_wagg.py's case of the same name (the
    length window's min/max lanes against a naive sliding window)."""
    P, W, T = 8, 5, 64
    rng = np.random.default_rng(3)
    values = rng.uniform(0, 100, (P, T)).astype(np.float32)
    accepted = rng.random((P, T)) < 0.6
    _, (s, n, mn, mx) = wagg_step_plain(
        make_wagg_carry(P, W, "cpu"), torch.from_numpy(values),
        torch.from_numpy(accepted), want_minmax=True)
    for p in range(P):
        win = []
        for t in range(T):
            if accepted[p, t]:
                win.append(values[p, t])
                win = win[-W:]
            if win:
                assert mn[p, t].item() == pytest.approx(min(win)), (p, t)
                assert mx[p, t].item() == pytest.approx(max(win)), (p, t)


# ----------------------------------------------------------- the compiler

TIME_APP = """
define stream S (k int, ets long, v float);
@info(name='q')
from S[v > 2.0]#window.{window}
select k, sum(v) as total, count() as n, min(v) as lo, max(v) as hi,
       avg(v) as a
group by k
insert into Out;
"""


def _blocks(seed, n, P, n_blocks, integer=True):
    rng = np.random.default_rng(seed)
    base = 1 << 41                      # epoch-like ms: the i32 rebase
    t = base
    for _ in range(n_blocks):
        pids = rng.integers(0, P, n)
        vals = (rng.integers(0, 10, n) if integer
                else rng.uniform(0, 10, n)).astype(np.float32)
        ts = t + np.cumsum(rng.integers(1, 60, n)).astype(np.int64)
        t = int(ts[-1])
        ets = ts - base + rng.integers(-300, 300, n)   # out of order
        block, rows = pack_blocks(pids, {"k": pids.astype(np.float32),
                                         "ets": ets.astype(np.float32),
                                         "v": vals}, ts,
                                  np.zeros(n, np.int32), P,
                                  base_ts=int(ts[0]), return_rows=True)
        yield block, rows, pids, ts, ets


@pytest.mark.parametrize("window", ["time(500)", "externalTime(ets, 400)"])
def test_compiled_time_wagg_matches_jax(window, monkeypatch):
    """Same blocks through both compilers from a 4-slot ring: equal
    outputs (exact: integer-valued feed), carries, capacity after growth
    by replay, and current_aggregates."""
    monkeypatch.setattr(jwc, "TIME_CAPACITY_START", 4)
    monkeypatch.setattr(pwc, "TIME_CAPACITY_START", 4)
    app = TIME_APP.format(window=window)
    P = 5
    jx = jwc.CompiledWindowedAgg(app, n_partitions=P, use_pallas=False)
    pt = pwc.CompiledWindowedAgg(app, n_partitions=P, device="cpu")
    ext = window.startswith("externalTime")
    for block, rows, pids, ts, ets in _blocks(1, 60, P, 4):
        ts64 = np.zeros(block["__ts"].shape, np.int64)
        ts64[pids, rows] = ets if ext else ts
        block["__ts64"] = ts64
        oj = jx.process_block(dict(block))
        ot = pt.process_block(dict(block))
        valid = block["__valid"]
        for a, b in zip(oj, ot):
            assert _same_bits(np.asarray(a)[valid], b.numpy()[valid])
    assert pt.window == jx.window > 4
    for a, b in zip(jx.current_state()["carry"],
                    pt.current_state()["carry"]):
        assert _same_bits(a, b)
    assert pt.current_state()["ts_base"] == jx.current_state()["ts_base"]
    ga, gb = jx.current_aggregates(), pt.current_aggregates()
    for k in ga:
        assert np.allclose(np.asarray(ga[k], np.float64),
                           np.asarray(gb[k], np.float64), equal_nan=True), k


def test_jax_time_state_restores_into_compiler():
    app = TIME_APP.format(window="time(700)")
    P = 4
    feed = list(_blocks(2, 50, P, 4, integer=False))
    jx = jwc.CompiledWindowedAgg(app, n_partitions=P, use_pallas=False)
    for block, rows, pids, ts, _ in feed:
        ts64 = np.zeros(block["__ts"].shape, np.int64)
        ts64[pids, rows] = ts
        block["__ts64"] = ts64
    for block, *_ in feed[:2]:
        jx.process_block(dict(block))
    state = jx.current_state()
    carry = pwc.carry_from_reference(state, "cpu")
    assert carry.overflow.dtype == torch.bool
    assert carry.ring_ts.dtype == torch.int32
    pt = pwc.CompiledWindowedAgg(app, n_partitions=P, device="cpu")
    pt.restore_state(state)
    for block, *_ in feed[2:]:
        oj = jx.process_block(dict(block))
        ot = pt.process_block(dict(block))
        valid = block["__valid"]
        for i in (1, 2, 3):
            assert _same_bits(np.asarray(oj[i])[valid],
                              ot[i].numpy()[valid])
    for a, b in zip(jx.current_state()["carry"],
                    pt.current_state()["carry"]):
        assert _same_bits(a, b)


PARTITION_APP = """
@app:name('tw')
@app:playback
define stream S (sym string, price float);
partition with (sym of S) begin
@info(name='q')
from S[price > 1.0]#window.time(400)
select sym, sum(price) as s, count() as n, min(price) as lo,
       max(price) as hi
group by sym insert into Out;
end;
"""


def _stream_chunks(seed, n_chunks=6, n=40):
    rng = np.random.default_rng(seed)
    keys = np.array([f"k{i}" for i in range(5)], object)
    t, out = 1_000_000, []
    for _ in range(n_chunks):
        ts = t + np.cumsum(rng.integers(1, 40, n))
        t = int(ts[-1])
        out.append(({"sym": keys[rng.integers(0, 5, n)],
                     "price": rng.integers(0, 9, n).astype(np.float32)},
                    ts))
    return out


class _Run:
    def __init__(self, pkg, **kw):
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            PARTITION_APP)
        self.rows = []
        self.rt.add_callback("Out", pkg.StreamCallback(
            lambda evs: self.rows.extend(
                [e.timestamp] + list(e.data) for e in evs)))
        self.rt.start()

    def runtime(self):
        pr = self.rt.partition_runtimes[0]
        assert pr.device_mode, pr.fallback_reason
        return pr.device_query_runtimes["q"].device_runtime

    def send(self, chunks):
        h = self.rt.get_input_handler("S")
        for cols, ts in chunks:
            h.send_batch(cols, timestamps=ts)


def _norm(rows):
    return sorted([[float(x) if isinstance(x, (float, np.floating)) else
                    int(x) if isinstance(x, (int, np.integer)) else str(x)
                    for x in r] for r in rows], key=repr)


def test_partitioned_time_window_runs_k6_and_restores_jax_snapshot(
        monkeypatch):
    """The partitioned time window grouped by its key is a
    DeviceWindowedAggRuntime on the time step in both packages; the rows
    are equal, and a JAX snapshot (ring grown by replay) restores into
    the port, which then continues as the JAX run does."""
    monkeypatch.setattr(jwc, "TIME_CAPACITY_START", 4)
    monkeypatch.setattr(pwc, "TIME_CAPACITY_START", 4)
    chunks = _stream_chunks(4)
    jx, pt = _Run(siddhi_tpu), _Run(siddhi_tpu_torch, device="cpu")
    try:
        for r in (jx, pt):
            rt = r.runtime()
            assert type(rt).__name__ == "DeviceWindowedAggRuntime"
            assert rt.cwa.window_kind == "time"
        jx.send(chunks[:3])
        pt.send(chunks[:3])
        assert _norm(pt.rows) == _norm(jx.rows)
        snap = jx.rt.snapshot()
        n0 = len(jx.rows)
        jx.send(chunks[3:])
    finally:
        jx.rt.shutdown()
        pt.rt.shutdown()
    assert jx.runtime().cwa.window > 4
    pt2 = _Run(siddhi_tpu_torch, device="cpu")
    try:
        pt2.rt.restore(snap)
        assert pt2.runtime().cwa.window == jx.runtime().cwa.window
        pt2.send(chunks[3:])
    finally:
        pt2.rt.shutdown()
    assert len(pt2.rows) > 20
    assert _norm(pt2.rows) == _norm(jx.rows[n0:])
