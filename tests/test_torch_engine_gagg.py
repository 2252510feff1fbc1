"""Grouped aggregation, selection tails and filters through the public API:
JAX package vs torch port.

Each app runs through ``siddhi_tpu`` (its device engine on JAX's CPU
backend) and through ``siddhi_tpu_torch`` with
``SiddhiManager(device="cpu")`` (the plain steps).  Both must put the
query on the device engine — ``DeviceGroupedAggRuntime`` or
``DeviceFilterRuntime`` — and emit exactly the same rows (partitioned
apps: the same rows as a multiset, ordered by timestamp).  The shapes
are those of ``tests/test_device_grouped_agg.py`` and
``tests/test_select_device.py``, plus filters over string code lanes.
Runtime state carries across: a JAX ``current_state()`` restored into
the port continues with rows equal to the JAX run's.
"""
import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch

STREAM = ("define stream S (sym string, user string, price float, "
          "volume long);\n")

APPS = {
    "length_groupby": """
        @info(name='q') from S#window.length(5)
        select sym, sum(price) as s, count() as n, avg(price) as a,
               min(price) as lo, max(price) as hi
        group by sym insert into Out;""",
    "mixed_args_exact_int": """
        @info(name='q') from S[price > 20.0]#window.length(4)
        select sym, sum(price) as sp, sum(volume) as sv, avg(volume) as av,
               max(volume) as mv, min(price) as lo
        group by sym insert into Out;""",
    "two_keys": """
        @info(name='q') from S#window.length(6)
        select sym, user, sum(volume) as sv, count() as n
        group by sym, user insert into Out;""",
    "running_forever": """
        @info(name='q') from S
        select user, sum(volume) as sv, count() as n,
               minForever(price) as mnf, maxForever(price) as mxf,
               min(volume) as lo
        group by user insert into Out;""",
    "stddev": """
        @info(name='q') from S
        select sym, stdDev(price) as sd, avg(price) as a
        group by sym insert into Out;""",
    "time_having_order": """
        @info(name='q') from S#window.time(1 sec)
        select sym, sum(price) as t, sum(volume) as sv, count() as n
        group by sym having t > 20.0 order by t desc insert into Out;""",
    "external_time_int_sum": """
        @info(name='q') from S#window.externalTime(volume, 40)
        select sym, sum(price) as s, count() as n, max(price) as hi
        group by sym insert into Out;""",
    "running_having_order_limit": """
        @info(name='q') from S
        select sym, user, sum(price) as t, count() as n, max(price) as hi,
               min(volume) as lo
        group by sym, user having n >= 2 order by n asc, t desc
        limit 3 offset 1 insert into Out;""",
    "windowed_having_order": """
        @info(name='q') from S#window.length(4)
        select sym, sum(price) as t, max(price) as hi, count() as n
        group by sym having not (t < 10.0)
        order by hi desc, t asc insert into Out;""",
    "partition_finer_groupby": """
        partition with (sym of S) begin
        @info(name='q') from S#window.length(3)
        select sym, user, sum(price) as s, count() as n, max(volume) as mv
        group by sym, user insert into Out; end;""",
    "partition_time_window": """
        partition with (sym of S) begin
        @info(name='q') from S#window.time(500 millisec)
        select sym, sum(price) as s, count() as n
        group by sym insert into Out; end;""",
    "partition_running_int_sum": """
        partition with (sym of S) begin
        @info(name='q') from S
        select sym, sum(volume) as sv, maxForever(price) as mx
        group by sym insert into Out; end;""",
    "filter_string_lanes": """
        @info(name='q') from S[price > 50.0 and sym != 's1']
        select sym, price, price * 2.0 as p2, volume + 1 as v1
        insert into Out;""",
    "filter_string_order": """
        @info(name='q') from S[user >= 'u2' or sym == 's0']
        select * insert into Out;""",
    "filter_numeric": """
        @info(name='q') from S[volume > 0 and price < 70.0]
        select user, price / 4.0 as q, volume insert into Out;""",
}

RUNTIME = {"filter": "DeviceFilterRuntime"}
#: the JAX package runs a partitioned time window grouped by the partition
#: key on its time-window wagg step (K6, not yet ported); the port's
#: keyed fallback takes it to the grouped time step (K7b)
JAX_RUNTIME = {"partition_time_window": "DeviceWindowedAggRuntime"}


def _batches(seed, n_chunks=3, n=64):
    """Integer-valued prices (exact on every path, so sort keys tie
    alike), volumes usable as an externalTime stamp (increasing)."""
    rng = np.random.default_rng(seed)
    out, t0, v0 = [], 1_000_000, 0
    for _ in range(n_chunks):
        cols = {
            "sym": np.asarray([f"s{i}" for i in rng.integers(0, 3, n)],
                              object),
            "user": np.asarray([f"u{i}" for i in rng.integers(0, 4, n)],
                               object),
            "price": rng.integers(1, 100, n).astype(np.float32),
            "volume": (v0 + np.cumsum(rng.integers(0, 9, n))).astype(
                np.int64),
        }
        v0 = int(cols["volume"][-1])
        out.append((cols, t0 + np.cumsum(rng.integers(10, 90, n))))
        t0 = int(out[-1][1][-1])
    return out


class Run:
    def __init__(self, pkg, text, **kw):
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            "@app:playback\n" + STREAM + text)
        self.rows = []
        self.rt.add_callback("Out", pkg.StreamCallback(
            lambda evs: self.rows.extend(
                [e.timestamp] + list(e.data) for e in evs)))
        self.rt.start()

    def send(self, batches):
        h = self.rt.get_input_handler("S")
        for cols, ts in batches:
            h.send_batch(cols, timestamps=ts)

    def query(self):
        if self.rt.partition_runtimes:
            pr = self.rt.partition_runtimes[0]
            assert pr.device_mode, pr.fallback_reason
            return pr.device_query_runtimes["q"]
        return self.rt.query_runtimes["q"]

    def close(self):
        self.rt.shutdown()


def _norm(rows, partitioned):
    out = [[float(x) if isinstance(x, (float, np.floating)) else
            int(x) if isinstance(x, (int, np.integer)) else str(x)
            for x in r] for r in rows]
    # partitions emit per key clone on the host and in event order on
    # the device engines: compare as multisets ordered by timestamp
    return sorted(out, key=repr) if partitioned else out


@pytest.mark.parametrize("name", sorted(APPS))
def test_device_rows_equal_jax(name):
    text = APPS[name]
    partitioned = text.lstrip().startswith("partition")
    want = RUNTIME.get(name.split("_")[0], "DeviceGroupedAggRuntime")
    batches = _batches(sum(map(ord, name)))
    jx = Run(siddhi_tpu, text)
    pt = Run(siddhi_tpu_torch, text, device="cpu")
    try:
        for r, rt_name in ((jx, JAX_RUNTIME.get(name, want)), (pt, want)):
            qr = r.query()
            assert qr.backend == "device", qr.backend_reason
            assert type(qr.device_runtime).__name__ == rt_name
        assert pt.query().selection_route == jx.query().selection_route
        jx.send(batches)
        pt.send(batches)
    finally:
        jx.close()
        pt.close()
    assert len(jx.rows) > 5
    assert _norm(pt.rows, partitioned) == _norm(jx.rows, partitioned)


@pytest.mark.parametrize("name", ["length_groupby", "time_having_order",
                                  "running_having_order_limit",
                                  "partition_finer_groupby"])
def test_runtime_state_carries_from_jax(name):
    """JAX device runtime state → port restore_state → continue: the
    continuation's rows equal the JAX run's, and so do the carries."""
    text = APPS[name]
    partitioned = text.lstrip().startswith("partition")
    batches = _batches(sum(map(ord, name)) + 1, n_chunks=4)
    jx = Run(siddhi_tpu, text)
    pt = Run(siddhi_tpu_torch, text, device="cpu")
    try:
        jx.send(batches[:2])
        pt.query().device_runtime.restore_state(
            jx.query().device_runtime.current_state())
        n0 = len(jx.rows)
        jx.send(batches[2:])
        pt.send(batches[2:])
        a = jx.query().device_runtime.current_state()["cga"]
        b = pt.query().device_runtime.current_state()["cga"]
        assert a["gid_map"] == b["gid_map"]
        assert a["window"] == b["window"]
        for x, y in zip(a["carry"], b["carry"]):
            assert np.asarray(x).dtype == y.dtype
            assert np.array_equal(np.asarray(x), y, equal_nan=True)
    finally:
        jx.close()
        pt.close()
    assert len(pt.rows) > 5
    assert _norm(pt.rows, partitioned) == \
        _norm(jx.rows[n0:], partitioned)


def test_time_ring_grows_by_replay_like_jax():
    """A time window holding more live entries than the ring's first
    capacity (64) doubles it by rewind-and-replay: the port's ring ends
    at the JAX package's capacity with the same rows."""
    text = """
        @info(name='q') from S#window.time(10 sec)
        select sym, sum(price) as s, count() as n group by sym
        insert into Out;"""
    batches = _batches(5, n_chunks=3, n=120)
    jx = Run(siddhi_tpu, text)
    pt = Run(siddhi_tpu_torch, text, device="cpu")
    try:
        jx.send(batches)
        pt.send(batches)
        cj = jx.query().device_runtime.cga
        cp = pt.query().device_runtime.cga
        assert cp.window == cj.window > 64
    finally:
        jx.close()
        pt.close()
    assert _norm(pt.rows, False) == _norm(jx.rows, False)
