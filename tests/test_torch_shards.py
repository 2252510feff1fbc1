"""The torch port's partition shard-out vs the JAX package's.

With ``SIDDHI_TPU_SHARDS=4`` the keyed pattern, length-window
aggregation (wagg) and grouped aggregation (gagg) runtimes run in both
packages (the JAX package on its CPU devices, the port with
``SiddhiManager(device="cpu")``) on the same feed, made from a seed:
the rows must be equal as multisets (exact: both compute the same
float32 operations), and so must each shard's keys, events and
capacity, since both route by the same pinned FNV-1a hash.  A JAX
per-shard state restores into the port and continues with the JAX
run's rows; a port per-shard state restores into the JAX package; a
shard-count mismatch raises SC005 in both.
"""
import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch

APPS = {
    "pattern": """
        @app:name('ShP') define stream S (k string, v double);
        partition with (k of S) begin
        @info(name='q') from every e1=S[v > 1.0] -> e2=S[v > e1.v]
        within 40 select e1.k as k, e1.v as a, e2.v as b insert into Out;
        end;""",
    "wagg": """
        @app:name('ShW') define stream S (k string, v double);
        partition with (k of S) begin
        @info(name='q') from S[v > 0.5]#window.length(4)
        select k, sum(v) as s, count() as n, min(v) as lo, max(v) as hi
        group by k insert into Out; end;""",
    "gagg": """
        @app:name('ShG') define stream S (k string, v double);
        partition with (k of S) begin
        @info(name='q') from S[v > 0.2]
        select k, sum(v) as s, count() as n, max(v) as hi group by k
        insert into Out; end;""",
}
RUNTIME = {"pattern": "DevicePatternRuntime",
           "wagg": "DeviceWindowedAggRuntime",
           "gagg": "DeviceGroupedAggRuntime"}


def _batches(seed, n_chunks=4, n=200, n_keys=24):
    rng = np.random.default_rng(seed)
    out, t0 = [], 1_000_000
    for _ in range(n_chunks):
        cols = {"k": np.asarray([f"key-{i}" for i in
                                 rng.integers(0, n_keys, n)], object),
                "v": rng.integers(0, 30, n) / 10.0}
        out.append((cols, t0 + np.cumsum(rng.integers(0, 4, n))))
        t0 = int(out[-1][1][-1]) + 1
    return out


class Run:
    def __init__(self, pkg, name, monkeypatch, shards):
        monkeypatch.setenv("SIDDHI_TPU_SHARDS", str(shards))
        kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
        self.m = pkg.SiddhiManager(**kw)
        self.rt = self.m.create_siddhi_app_runtime(APPS[name])
        self.rows = []
        self.rt.add_callback("Out", pkg.StreamCallback(
            lambda evs: self.rows.extend(
                tuple([e.timestamp] + list(e.data)) for e in evs)))
        self.rt.start()
        pr = self.rt.partition_runtimes[0]
        assert pr.device_mode, pr.fallback_reason
        (qr,) = pr.device_query_runtimes.values()
        assert type(qr.device_runtime).__name__ == RUNTIME[name]
        self.dev = qr.device_runtime

    def send(self, batches):
        h = self.rt.get_input_handler("S")
        for cols, ts in batches:
            h.send_batch(cols, timestamps=ts)
        self.rt.flush()

    def close(self):
        self.m.shutdown()


@pytest.fixture(autouse=True)
def _mesh_off(monkeypatch):
    monkeypatch.setenv("SIDDHI_TPU_MESH", "off")


def _rows(rows):
    return sorted(tuple(round(x, 9) if isinstance(x, float) else x
                        for x in r) for r in rows)


def _shard_rows(run):
    return [{k: r[k] for k in ("shard", "keys", "capacity", "events",
                               "dispatches")}
            for r in run.dev.shard_stats()]


@pytest.mark.parametrize("name", sorted(APPS))
def test_sharded_rows_and_shard_stats_equal_jax(name, monkeypatch):
    batches = _batches(sum(map(ord, name)))
    jx = Run(siddhi_tpu, name, monkeypatch, 4)
    pt = Run(siddhi_tpu_torch, name, monkeypatch, 4)
    mono = Run(siddhi_tpu_torch, name, monkeypatch, 0)
    try:
        for r in (jx, pt, mono):
            r.send(batches)
        assert len(pt.dev.shards) == 4 and mono.dev.shards is None
        assert _shard_rows(pt) == _shard_rows(jx)
        assert {r["device"] for r in pt.dev.shard_stats()} == \
            {f"cpu:{i}" for i in range(4)}
        stats = pt.rt.statistics["shards"]
        assert [len(v) for v in stats.values()] == [4]
    finally:
        jx.close()
        pt.close()
        mono.close()
    assert len(pt.rows) > 10
    assert _rows(pt.rows) == _rows(jx.rows) == _rows(mono.rows)


@pytest.mark.parametrize("name", sorted(APPS))
def test_per_shard_state_crosses_packages(name, monkeypatch):
    """JAX per-shard state → the port → continue (rows equal the JAX
    run's continuation); the port's state → the JAX package → continue
    (equal again)."""
    batches = _batches(sum(map(ord, name)) + 1, n_chunks=4)
    jx = Run(siddhi_tpu, name, monkeypatch, 4)
    pt = Run(siddhi_tpu_torch, name, monkeypatch, 4)
    jx2 = Run(siddhi_tpu, name, monkeypatch, 4)
    try:
        jx.send(batches[:2])
        state = jx.dev.current_state()
        assert len(state["shards"]) == 4
        pt.dev.restore_state(state)
        n0 = len(jx.rows)
        jx.send(batches[2:3])
        pt.send(batches[2:3])
        assert _rows(pt.rows) == _rows(jx.rows[n0:])
        jx2.dev.restore_state(pt.dev.current_state())
        n1, n2 = len(jx.rows), len(pt.rows)
        jx.send(batches[3:])
        jx2.send(batches[3:])
        pt.send(batches[3:])
        assert _rows(jx2.rows) == _rows(jx.rows[n1:]) == \
            _rows(pt.rows[n2:])
        assert len(jx2.rows) > 0
    finally:
        jx.close()
        pt.close()
        jx2.close()


def test_shard_count_mismatch_raises_sc005_in_both(monkeypatch):
    batches = _batches(5, n_chunks=1)
    jx4 = Run(siddhi_tpu, "gagg", monkeypatch, 4)
    pt4 = Run(siddhi_tpu_torch, "gagg", monkeypatch, 4)
    jx2 = Run(siddhi_tpu, "gagg", monkeypatch, 2)
    pt2 = Run(siddhi_tpu_torch, "gagg", monkeypatch, 2)
    try:
        jx4.send(batches)
        pt4.send(batches)
        for dst, src in ((pt2, jx4), (jx2, pt4), (pt2, pt4)):
            with pytest.raises(Exception) as e:
                dst.dev.restore_state(src.dev.current_state())
            assert "SC005" in str(e.value)
            assert getattr(e.value, "code", None) == "SC005"
    finally:
        for r in (jx4, pt4, jx2, pt2):
            r.close()
