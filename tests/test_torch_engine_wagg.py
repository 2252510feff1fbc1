"""The public partitioned length-window path: JAX package vs torch port.

One app — string partition keys, a filter, sum/count/avg/min/max — runs
through ``siddhi_tpu`` on JAX's CPU backend and through
``siddhi_tpu_torch`` with ``SiddhiManager(device="cpu")`` (the plain
PyTorch step).  Both must put every query on the device engine and emit
EXACTLY the same rows, at pipeline depth 0 and at depth 2 under @Async
(in-flight queue + the fused egress slab).  The port's host engine must
emit exactly the JAX package's host rows, and runtime state must carry
across: JAX ``current_state`` → port ``restore_state`` → continue.
"""
import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch

HEAD_SYNC = ""
HEAD_ASYNC = "@app:pipeline('2')\n"
STREAM_SYNC = "define stream S (sym string, price float, kind int);"
STREAM_ASYNC = ("@Async(buffer.size='16', batch.size.max='512')\n"
                + STREAM_SYNC)

BODY = """
partition with (sym of S) begin
@info(name='q0')
from S[price > 2.5]#window.length(6)
select sym, sum(price) as s, count() as n, avg(price) as a,
       min(price) as lo, max(price) as hi
group by sym insert into Out0;
@info(name='q1')
from S[price * 2.0 > 9.0 and kind != 3]#window.length(3)
select sym, sum(price) as s, max(price) as hi, count() as n
group by sym insert into Out1;
end;
"""


def app_text(asyncio: bool, engine: str = "auto") -> str:
    head = "@app:name('wagg')\n@app:playback\n"
    if engine != "auto":
        head += f"@app:engine('{engine}')\n"
    head += HEAD_ASYNC if asyncio else HEAD_SYNC
    return head + (STREAM_ASYNC if asyncio else STREAM_SYNC) + BODY


def feed(seed: int, n: int, chunks: int):
    rng = np.random.default_rng(seed)
    keys = np.array([f"key-{i}" for i in range(11)], object)
    out = []
    t0 = 1_000_000
    for c in range(chunks):
        sym = keys[rng.integers(0, len(keys), n)]
        price = rng.uniform(0.0, 10.0, n).astype(np.float32)
        kind = rng.integers(0, 5, n).astype(np.int32)
        ts = t0 + c * n + np.arange(n, dtype=np.int64)
        out.append(({"sym": sym, "price": price, "kind": kind}, ts))
    return out


class Run:
    """One app runtime of either package, collecting rows per stream."""

    def __init__(self, pkg, text: str, **mgr_kw):
        self.mgr = pkg.SiddhiManager(**mgr_kw)
        self.rt = self.mgr.create_siddhi_app_runtime(text)
        self.rows = {"Out0": [], "Out1": []}
        for sid, rows in self.rows.items():
            self.rt.add_callback(sid, pkg.StreamCallback(
                lambda evs, rows=rows: rows.extend(
                    [e.timestamp] + list(e.data) for e in evs)))
        self.rt.start()
        self.h = self.rt.get_input_handler("S")

    def send(self, chunks):
        for cols, ts in chunks:
            self.h.send_batch(cols, timestamps=ts)

    def device_runtimes(self):
        pr = self.rt.partition_runtimes[0]
        assert pr.device_mode, pr.fallback_reason
        return {n: qr for n, qr in pr.device_query_runtimes.items()}

    def close(self):
        self.rt.shutdown()


def _norm(rows):
    return [[float(x) if isinstance(x, (float, np.floating)) else
             int(x) if isinstance(x, (int, np.integer)) else str(x)
             for x in r] for r in rows]


@pytest.mark.parametrize("asyncio", [False, True], ids=["depth0", "depth2"])
def test_device_rows_equal_jax(asyncio):
    chunks = feed(3, 300, 4)
    jx = Run(siddhi_tpu, app_text(asyncio))
    pt = Run(siddhi_tpu_torch, app_text(asyncio), device="cpu")
    try:
        for r in (jx, pt):
            qrs = r.device_runtimes()
            assert set(qrs) == {"q0", "q1"}
            for qr in qrs.values():
                assert qr.backend == "device"
                assert type(qr.device_runtime).__name__ == \
                    "DeviceWindowedAggRuntime"
                assert qr.device_runtime.pipeline_depth == \
                    (2 if asyncio else 0)
        jx.send(chunks)
        pt.send(chunks)
    finally:
        jx.close()
        pt.close()
    for sid in ("Out0", "Out1"):
        assert len(jx.rows[sid]) > 100
        assert _norm(pt.rows[sid]) == _norm(jx.rows[sid]), sid


def test_host_engine_rows_equal_jax_host_and_device():
    chunks = feed(4, 250, 3)
    jx = Run(siddhi_tpu, app_text(False, engine="host"))
    pt = Run(siddhi_tpu_torch, app_text(False, engine="host"),
             device="cpu")
    dev = Run(siddhi_tpu_torch, app_text(False), device="cpu")
    try:
        assert not pt.rt.partition_runtimes[0].device_mode
        for r in (jx, pt, dev):
            r.send(chunks)
    finally:
        for r in (jx, pt, dev):
            r.close()
    for sid in ("Out0", "Out1"):
        assert _norm(pt.rows[sid]) == _norm(jx.rows[sid]), sid
        # device vs host engine: float32 Kahan sums against the host's
        # float64 aggregators — rel 1e-5 (tests/test_tpu_wagg.py's bound);
        # keys, counts, min/max exact
        # (the host partition emits per key clone, the device in event
        # order: compare by timestamp, unique per event)
        h = sorted(pt.rows[sid], key=lambda r: r[0])
        d = sorted(dev.rows[sid], key=lambda r: r[0])
        assert len(h) == len(d)
        names = ["ts", "sym", "s", "n", "a", "lo", "hi"] if sid == "Out0" \
            else ["ts", "sym", "s", "hi", "n"]
        for rh, rd in zip(h, d):
            for name, x, y in zip(names, rh, rd):
                if name in ("s", "a"):
                    assert y == pytest.approx(x, rel=1e-5), name
                else:
                    assert x == y, name


def test_runtime_state_carries_from_jax():
    """JAX device runtime state → port restore_state → continue: the
    second half's rows equal a JAX run that never stopped."""
    first, second = feed(5, 200, 2), feed(6, 200, 2)
    second = [(c, ts + 10_000) for c, ts in second]
    jx = Run(siddhi_tpu, app_text(False))
    pt = Run(siddhi_tpu_torch, app_text(False), device="cpu")
    try:
        jx.send(first)
        jq, pq = jx.device_runtimes(), pt.device_runtimes()
        for name in ("q0", "q1"):
            pq[name].device_runtime.restore_state(
                jq[name].device_runtime.current_state())
        n0 = {sid: len(rows) for sid, rows in jx.rows.items()}
        jx.send(second)
        pt.send(second)
        for name in ("q0", "q1"):
            a = jq[name].device_runtime.current_state()["cwa"]["carry"]
            b = pq[name].device_runtime.current_state()["cwa"]["carry"]
            for x, y in zip(a, b):
                assert (np.asarray(x) == y).all()
    finally:
        jx.close()
        pt.close()
    for sid in ("Out0", "Out1"):
        assert len(pt.rows[sid]) > 50
        assert _norm(pt.rows[sid]) == _norm(jx.rows[sid][n0[sid]:]), sid


def test_persist_restore_roundtrip_on_port():
    """persist() → restore_revision() into a fresh port runtime: the
    continuation equals the uninterrupted run (the snapshot envelope's
    schema verification accepts the port's numpy state)."""
    store = siddhi_tpu_torch.InMemoryPersistenceStore()
    first, second = feed(7, 200, 2), feed(8, 200, 2)
    second = [(c, ts + 10_000) for c, ts in second]

    def runtime():
        r = Run(siddhi_tpu_torch, app_text(False), device="cpu")
        r.mgr.set_persistence_store(store)
        return r

    a = runtime()
    try:
        a.send(first)
        rev = a.rt.persist()
        n0 = {sid: len(rows) for sid, rows in a.rows.items()}
        a.send(second)
    finally:
        a.close()
    b = runtime()
    try:
        b.rt.restore_revision(rev)
        b.send(second)
    finally:
        b.close()
    for sid in ("Out0", "Out1"):
        assert len(b.rows[sid]) > 50
        assert _norm(b.rows[sid]) == _norm(a.rows[sid][n0[sid]:]), sid
