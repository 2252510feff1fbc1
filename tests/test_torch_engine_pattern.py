"""The pattern path through the public API: the torch port's device engine
(the plain step, on the CPU) vs the JAX package's device engine and the
port's host engine.

Every run feeds the same batches (made from a seed with numpy) and
compares sorted (ts, p1, p2) payloads, as ``__graft_entry__._run_app``
does.  Also: grow-and-replay from a one-slot ring, lane growth past
``@app:lanes``, a JAX runtime's snapshot restored into the port, the
no-jax import rule, and ``chip_smoke.py``'s pattern reference.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as graft  # noqa: E402
import chip_smoke  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.plan import planner  # noqa: E402


def _batches(seed=3, n_keys=12, n_batches=3, per=160, t0=1_000_000,
             gap=20_000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        out.append((
            {"partition": rng.integers(0, n_keys, per).astype(np.int32),
             "price": rng.uniform(0, 100, per).astype(np.float32),
             "kind": rng.integers(0, 2, per).astype(np.int32)},
            t0 + np.arange(per, dtype=np.int64) * 40))
        t0 += gap
    return out


def _start(pkg, text, engine, device="cpu"):
    kw = {"device": device} if pkg is siddhi_tpu_torch else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        f"@app:engine('{engine}') {text}")
    got = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: got.extend((e.timestamp, round(e.data[0], 4),
                                round(e.data[1], 4)) for e in evs)))
    rt.start()
    return rt, got


def _feed(rt, batches):
    h = rt.get_input_handler("S")
    for cols, ts in batches:
        h.send_batch(cols, timestamps=ts)
    rt.flush()


def _run(pkg, text, engine, batches):
    rt, got = _start(pkg, text, engine)
    try:
        _feed(rt, batches)
        return sorted(got), rt
    finally:
        rt.shutdown()


def _device_runtime(rt, partitioned=True):
    if partitioned:
        pr = rt.partition_runtimes[0]
        assert pr.device_mode, pr.fallback_reason
        (qr,) = pr.device_query_runtimes.values()
    else:
        (qr,) = rt.query_runtimes.values()
    assert qr.backend == "device", qr.backend_reason
    return qr.device_runtime


@pytest.mark.parametrize("name", ["PARTITIONED_APP", "APP"])
def test_port_device_equals_jax_device_and_host(name):
    text = getattr(graft, name)
    if name == "APP":
        text = "@app:playback " + text
    batches = _batches()
    port, rt = _run(siddhi_tpu_torch, text, "device", batches)
    dev = _device_runtime(rt, name == "PARTITIONED_APP")
    assert type(dev).__name__ == "DevicePatternRuntime"
    assert dev.nfa.device.type == "cpu"
    jax_rows, jrt = _run(siddhi_tpu, text, "device", batches)
    _device_runtime(jrt, name == "PARTITIONED_APP")
    host, hrt = _run(siddhi_tpu_torch, text, "host", batches)
    assert len(port) > 10
    assert port == jax_rows
    assert port == host


def test_grow_and_replay_from_one_slot(monkeypatch):
    """A one-slot ring overflows; every overflowing chunk is replayed on
    a doubled ring, so the rows equal the unbounded host run."""
    text = graft.PARTITIONED_APP
    batches = _batches(seed=4, n_keys=4, per=300)
    monkeypatch.setattr(planner, "DEFAULT_SLOTS", 1)
    got, rt = _run(siddhi_tpu_torch, text, "device", batches)
    dev = _device_runtime(rt)
    assert dev.slot_grows > 0 and dev.replays > 0
    assert dev.nfa.spec.n_slots > 1
    host, _ = _run(siddhi_tpu_torch, text, "host", batches)
    monkeypatch.setattr(planner, "DEFAULT_SLOTS", 8)
    wide, _ = _run(siddhi_tpu_torch, text, "device", batches)
    assert got == host == wide and len(got) > 10


def test_lane_growth_past_declared_lanes():
    text = "@app:lanes('8') " + graft.PARTITIONED_APP
    batches = _batches(seed=5, n_keys=40, per=400)
    got, rt = _run(siddhi_tpu_torch, text, "device", batches)
    dev = _device_runtime(rt)
    assert len(dev.key_lanes) == 40 and dev.nfa.n_partitions == 64
    host, _ = _run(siddhi_tpu_torch, text, "host", batches)
    assert got == host and len(got) > 10


def test_jax_snapshot_restores_into_port():
    """A JAX DevicePatternRuntime's current_state() (numpy carry leaves +
    key→lane map) restores unchanged into the port; both continue on the
    same events and emit the same rows."""
    text = graft.PARTITIONED_APP
    first = _batches(seed=6, n_keys=10, per=200, n_batches=2)
    rest = _batches(seed=7, n_keys=14, per=200, n_batches=2,
                    t0=1_000_000 + 2 * 20_000 + 300)
    jrt, jgot = _start(siddhi_tpu, text, "device")
    prt, pgot = _start(siddhi_tpu_torch, text, "device")
    try:
        _feed(jrt, first)
        state = _device_runtime(jrt).current_state()
        assert isinstance(state["nfa"]["carry"]["slot_state"], np.ndarray)
        pdev = _device_runtime(prt)
        pdev.restore_state(state)
        assert pdev.nfa.n_partitions == state["nfa"]["n_partitions"]
        n0 = len(jgot)
        _feed(jrt, rest)
        _feed(prt, rest)
        assert len(jgot) - n0 > 5
        assert sorted(pgot) == sorted(jgot[n0:])
        back = pdev.current_state()
        assert sorted(back["nfa"]["carry"]) == sorted(state["nfa"]["carry"])
    finally:
        jrt.shutdown()
        prt.shutdown()


def test_nfa_modules_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys\n"
            "import siddhi_tpu_torch.plan.nfa_compiler, "
            "siddhi_tpu_torch.ops.nfa\n"
            "bad = [m for m in sys.modules if m in ('jax', 'siddhi_tpu') "
            "or m.startswith(('jax.', 'siddhi_tpu.'))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_pattern_app_is_the_graft_app():
    assert chip_smoke.PARTITIONED_APP == graft.PARTITIONED_APP


def test_chip_smoke_reference_equals_host_engine():
    """chip_smoke.py's independent per-key reference of PARTITIONED_APP
    equals the port's host engine, row for row (the host engine emits a
    batch key by key: its rows are put in time order first, a stable sort
    keeping one key's same-time rows in their arm order)."""
    chunks = chip_smoke.make_pattern_chunks(0, 3, n_keys=20, chunk=1500)
    rts, p1, p2 = chip_smoke.pattern_reference(chunks)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime("@app:engine('host') " +
                                   chip_smoke.PARTITIONED_APP)
    got = []
    rt.add_callback("Out", siddhi_tpu_torch.StreamCallback(
        lambda evs: got.extend((e.timestamp, e.data[0], e.data[1])
                               for e in evs)))
    rt.start()
    try:
        _feed(rt, chunks)
    finally:
        rt.shutdown()
    assert len(got) == len(rts) > 50
    got.sort(key=lambda g: g[0])
    assert [g[0] for g in got] == list(rts)
    assert np.array_equal(np.asarray([g[1] for g in got], np.float32), p1)
    assert np.array_equal(np.asarray([g[2] for g in got], np.float32), p2)


def test_shard_out_not_yet_ported(monkeypatch):
    # SIDDHI_TPU_SHARDS=2 builds the keyed pattern runtime on the device
    # engine with two shards
    monkeypatch.setenv("SIDDHI_TPU_SHARDS", "2")
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(graft.PARTITIONED_APP)
    try:
        pr = rt.partition_runtimes[0]
        assert pr.device_mode, pr.fallback_reason
        (qr,) = pr.device_query_runtimes.values()
        assert len(qr.device_runtime.shards) == 2
        assert qr.device_runtime.shard_reason is None
    finally:
        rt.shutdown()


def test_persist_restore_through_the_public_api():
    """persist() → a new runtime → restore_revision(): the restored
    pattern runtime continues as the uninterrupted one does."""
    text = graft.PARTITIONED_APP
    first = _batches(seed=8, n_keys=10, per=200, n_batches=2)
    rest = _batches(seed=9, n_keys=10, per=200, n_batches=2,
                    t0=1_000_000 + 2 * 20_000 + 300)
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    mgr.set_persistence_store(siddhi_tpu_torch.InMemoryPersistenceStore())

    def start():
        rt = mgr.create_siddhi_app_runtime(f"@app:engine('device') {text}")
        got = []
        rt.add_callback("Out", siddhi_tpu_torch.StreamCallback(
            lambda evs: got.extend((e.timestamp, round(e.data[0], 4),
                                    round(e.data[1], 4)) for e in evs)))
        rt.start()
        return rt, got
    whole, whole_rows = start()
    rt, _ = start()
    try:
        _feed(whole, first)
        _feed(rt, first)
        rev = rt.persist()
        rt.shutdown()
        n0 = len(whole_rows)
        _feed(whole, rest)
        rt, got = start()
        rt.restore_revision(rev)
        _feed(rt, rest)
        assert len(whole_rows) - n0 > 5
        assert sorted(got) == sorted(whole_rows[n0:])
    finally:
        whole.shutdown()
        rt.shutdown()


def test_schema_digests_equal_the_reference():
    """The persisted layouts are declared alike, so SC0xx snapshot
    verification holds both ways between the packages."""
    # importing the classes registers their declarations
    import siddhi_tpu.plan.planner  # noqa: F401
    import siddhi_tpu_torch.plan.nfa_compiler  # noqa: F401
    from siddhi_tpu.core.stateschema import registry as ref_registry
    from siddhi_tpu_torch.core.stateschema import registry
    want = {d.name: d.digest() for d in ref_registry().values()}
    got = {d.name: d.digest() for d in registry().values()}
    for name in ("keyed-pattern", "nfa-engine"):
        assert got[name] == want[name], name
