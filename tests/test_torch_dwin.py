"""The device window step (K9) and the device window path: JAX vs port.

- ``dwin_step_plain`` (the torch twin) against the JAX package's
  ``build_dwin_step`` on the same chained steps, for all twelve kinds:
  bit for bit on the whole egress buffer (rows, the JAX padding, the
  telemetry row, the tail) and on every carry leaf.  The feeds cover
  timer steps without events, ring overflow, externalTime out of order,
  sort ties and LONG (hi, lo) keys, keyed and keyless sessions, hopping
  flush and append steps and telemetry.
- ``dwin_pass_model`` (the CPU model of ``csrc/dwin_step.cu``'s passes,
  with a small block so that entries span many blocks) against the twin,
  bit for bit on the rows up to the count, the tail, the telemetry row
  and every carry leaf.
- The public path: the same apps through both packages' device engines
  (``DeviceWindowProcessor`` on both sides) emit the same rows, and a JAX
  snapshot of a device window restores into the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.ops import dwin as J
from siddhi_tpu.plan import dwin_compiler as JC
from siddhi_tpu_torch.ops import dwin as D
from siddhi_tpu_torch.plan import dwin_compiler as PC
from siddhi_tpu_torch.utils.errors import SiddhiAppCreationError

#: (kind, capacity, n_f, n_i, window_ms, length, sort_keys, skey_lane,
#: telemetry, hop_ms)
SPECS = {
    "length": ("length", 8, 1, 2, 0, 3),
    "time": ("time", 8, 1, 2, 100, 0),
    "time_overflow": ("time", 4, 1, 1, 400, 0, (), -1, True),
    "externalTime_ooo": ("externalTime", 8, 1, 2, 100, 0),
    "timeLength": ("timeLength", 8, 2, 1, 100, 3),
    "delay": ("delay", 8, 1, 1, 100, 0),
    "lengthBatch": ("lengthBatch", 8, 1, 1, 0, 3),
    "timeBatch": ("timeBatch", 8, 1, 1, 1000, 0),
    "timeBatch_telemetry": ("timeBatch", 8, 1, 1, 1000, 0, (), -1, True),
    "externalTimeBatch": ("externalTimeBatch", 8, 1, 3, 500, 0),
    "batch": ("batch", 8, 1, 1, 0, 0),
    "sort_ties": ("sort", 8, 1, 2, 0, 3, ((0, 0, True),)),
    "sort_long_desc": ("sort", 8, 1, 3, 0, 4,
                       ((1, 1, False), (1, 2, False), (0, 0, True))),
    "session_keyed": ("session", 8, 1, 2, 300, 0, (), 1),
    "session_keyless": ("session", 8, 1, 1, 300, 0, (), 0),
    "hopping": ("hopping", 8, 1, 1, 300, 0, (), -1, False, 100),
    "length_telemetry": ("length", 8, 1, 2, 0, 3, (), -1, True),
}


def _steps(spec, seed, n_steps=10, sizes=(1, 4, 11)):
    """Chained step inputs (numpy; T from ``sizes``, so the jitted JAX
    step compiles once a size): integer-valued or normal f32 payloads
    (sort ties), small ints (session keys, LONG hi/lo lanes), timer steps
    with no valid row, out-of-order externalTime stamps, the batch kinds'
    flush ids and the hopping flush flag."""
    rng = np.random.default_rng(seed)
    F, I = max(spec.n_f, 1), max(spec.n_i, 1)
    t0 = 1000
    out = []
    for _ in range(n_steps):
        T = int(rng.choice(sizes))
        ev_f = rng.integers(0, 4, (1, T, F)).astype(np.float32)
        if rng.random() < 0.3:
            ev_f = rng.normal(size=(1, T, F)).astype(np.float32)
        ev_i = rng.integers(-2, 3, (1, T, I)).astype(np.int32)
        ts = t0 + np.cumsum(rng.integers(0, 40, T))
        if spec.kind == "externalTime" and rng.random() < 0.5:
            ts = t0 + rng.integers(0, 300, T)
        valid = np.ones((1, T), bool)
        if rng.random() < 0.2:
            valid[:] = False                       # a timer step
        t0 = int(ts.max()) + 1
        now = np.asarray([t0 + int(rng.integers(-50, 800))], np.int32)
        directive = np.zeros((1, T), np.int32)
        if spec.kind in ("timeBatch", "externalTimeBatch"):
            n_done = int(rng.integers(0, 3))
            directive[0] = np.sort(rng.integers(0, n_done + 1, T))
            now = np.asarray([n_done], np.int32)
        if spec.kind == "hopping":
            directive[0, 0] = int(rng.random() < 0.5)
        out.append((ev_f, ev_i, ts[None].astype(np.int32), valid, now,
                    directive, 2 * spec.capacity + T))
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_equals_jax(name):
    spec_t = D.DwinSpec(*SPECS[name])
    spec_j = J.DwinSpec(*SPECS[name])
    step_j = jax.jit(J.build_dwin_step(spec_j), static_argnums=7)
    for seed in (0, 1):
        cj = {k: jnp.asarray(v)
              for k, v in J.make_dwin_carry(spec_j, 1).items()}
        ct = D.make_dwin_carry(spec_t, 1, "cpu")
        assert set(cj) == set(ct)
        overflowed = False
        for s, (*inp, cap) in enumerate(_steps(spec_t, seed)):
            cj, bj = step_j(cj, *[jnp.asarray(a) for a in inp], cap)
            ct, bt = D.dwin_step_plain(
                spec_t, ct, *[torch.from_numpy(a) for a in inp], cap)
            assert np.array_equal(np.asarray(bj), bt.numpy()), (name, s)
            for k in cj:
                assert np.array_equal(_bits(cj[k]), _bits(ct[k].numpy())), \
                    (name, s, k)
            overflowed |= bool(bt[-1, 4])
        if name == "time_overflow":
            assert overflowed


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pass_model_equals_plain(name):
    """csrc/dwin_step.cu's passes (numpy model, 4-entry blocks) == the
    twin, bit for bit on what the kernel writes."""
    spec = D.DwinSpec(*SPECS[name])
    for seed in (2, 3):
        ct = D.make_dwin_carry(spec, 1, "cpu")
        for s, (*inp, cap) in enumerate(_steps(spec, seed)):
            npc = {k: v.numpy() for k, v in ct.items()}
            cm, bm = D.dwin_pass_model(spec, npc, *inp, cap, block=4)
            ct, bt = D.dwin_step_plain(
                spec, ct, *[torch.from_numpy(a) for a in inp], cap)
            bt = bt.numpy()
            n = min(int(bt[-1, 0]), cap)
            assert np.array_equal(bm[:n], bt[:n]), (name, s)
            assert np.array_equal(bm[cap:], bt[cap:]), (name, s)
            for k in ct:
                assert np.array_equal(_bits(cm[k]), _bits(ct[k].numpy())), \
                    (name, s, k)


def test_searchsorted_scan_is_jax_on_unsorted_rows():
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 7, 8, 33):
        a = rng.integers(0, 50, (3, n)).astype(np.int32)
        q = rng.integers(-5, 60, (3, 40)).astype(np.int32)
        want = np.stack([np.asarray(jnp.searchsorted(a[p], q[p]))
                         for p in range(3)])
        got = D.searchsorted_scan(torch.from_numpy(a), torch.from_numpy(q))
        assert np.array_equal(want, got.numpy()), n


def test_device_kinds_are_the_jax_literal():
    assert PC.DEVICE_KINDS == JC.DEVICE_KINDS
    assert set(D.KIND_IDS) == set(PC.DEVICE_KINDS)


def test_step_raises_on_unsupported_device():
    spec = D.DwinSpec(*SPECS["length"])
    carry = {k: v.to("meta") for k, v in
             D.make_dwin_carry(spec, 1, "cpu").items()}
    ev = [torch.empty((1, 2, 1), device="meta"),
          torch.empty((1, 2, 2), dtype=torch.int32, device="meta"),
          torch.empty((1, 2), dtype=torch.int32, device="meta"),
          torch.empty((1, 2), dtype=torch.bool, device="meta"),
          torch.empty((1,), dtype=torch.int32, device="meta"),
          torch.empty((1, 2), dtype=torch.int32, device="meta")]
    with pytest.raises(RuntimeError, match="no kernel"):
        D.dwin_step(spec, carry, *ev, 20)


# ------------------------------------------------------------ public path

CSE = "define stream cse (symbol string, price float, volume long);\n"
QUERIES = {
    "length": "#window.length(5)",
    "lengthBatch": "#window.lengthBatch(4)",
    "time": "#window.time(1 sec)",
    "timeBatch": "#window.timeBatch(1 sec)",
    "externalTime": "#window.externalTime(volume, 500)",
    "externalTimeBatch": "#window.externalTimeBatch(volume, 500)",
    "timeLength": "#window.timeLength(1 sec, 4)",
    "delay": "#window.delay(300)",
    "batch": "#window.batch()",
    "sort": "#window.sort(4, volume, 'desc', price)",
    "session": "#window.session(700, symbol)",
    "hopping": "#window.hopping(1 sec, 300)",
}


def _chunks(seed, n_events=48):
    rng = np.random.default_rng(seed)
    ts = 1_000_000 + np.cumsum(rng.integers(1, 400, n_events))
    syms = rng.choice(np.asarray(["A", "B", "C"], object), n_events)
    price = rng.integers(0, 20, n_events).astype(np.float32)
    vol = ts - 999_000
    out, i = [], 0
    while i < n_events:
        k = int(rng.integers(1, 7))
        sl = slice(i, min(i + k, n_events))
        out.append(({"symbol": syms[sl], "price": price[sl],
                     "volume": vol[sl]}, ts[sl]))
        i += k
    return out


class Run:
    def __init__(self, pkg, app, **kw):
        self.pkg = pkg
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            "@app:playback\n" + app)
        self.log = []
        self.rt.add_callback("q", pkg.QueryCallback(
            lambda ts, cur, exp: self.log.append(
                (ts, [(e.timestamp, tuple(e.data)) for e in (cur or [])],
                 [(e.timestamp, tuple(e.data)) for e in (exp or [])]))))
        self.rt.start()

    def window(self):
        (w,) = self.rt.query_runtimes["q"].windows
        return w

    def send(self, chunks):
        h = self.rt.get_input_handler("cse")
        for cols, ts in chunks:
            h.send_batch(cols, timestamps=ts)

    def close(self):
        self.rt.shutdown()


def _app(kind):
    return CSE + f"@info(name='q') from cse{QUERIES[kind]} " \
        "select symbol, price, volume insert all events into out;"


@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_device_window_rows_equal_jax(kind):
    chunks = _chunks(sum(map(ord, kind)))
    jx = Run(siddhi_tpu, _app(kind))
    pt = Run(siddhi_tpu_torch, _app(kind), device="cpu")
    try:
        for r in (jx, pt):
            assert type(r.window()).__name__ == "DeviceWindowProcessor"
            assert r.rt.query_runtimes["q"].backend == "device"
        jx.send(chunks)
        pt.send(chunks)
        assert len(jx.log) > 3
        assert pt.log == jx.log
        assert pt.window().capacity == jx.window().capacity
    finally:
        jx.close()
        pt.close()


@pytest.mark.parametrize("kind", ["lengthBatch", "time", "sort", "session",
                                  "hopping", "externalTimeBatch"])
def test_jax_snapshot_restores_into_port(kind):
    """JAX runtime snapshot → port restore → continue: the port emits the
    JAX run's continuation, and its carry is the JAX carry."""
    chunks = _chunks(sum(map(ord, kind)) + 1)
    mid = len(chunks) // 2
    jx = Run(siddhi_tpu, _app(kind))
    pt = Run(siddhi_tpu_torch, _app(kind), device="cpu")
    try:
        jx.send(chunks[:mid])
        snap = jx.rt.snapshot()
        state = jx.window().current_state()
        n0 = len(jx.log)
        carry = PC.carry_from_reference(state, "cpu")
        for k, v in state["dwin"].items():
            assert carry[k].dtype == torch.tensor(np.asarray(v)).dtype
            assert np.array_equal(_bits(v), _bits(carry[k].numpy())), k
        pt.rt.restore(snap)
        jx.send(chunks[mid:])
        pt.send(chunks[mid:])
        assert pt.log == jx.log[n0:]
        a, b = jx.window().current_state(), pt.window().current_state()
        for k in a["dwin"]:
            assert np.array_equal(_bits(a["dwin"][k]), _bits(b["dwin"][k]))
        assert {k: v for k, v in a.items() if k != "dwin"} == \
            {k: v for k, v in b.items() if k != "dwin"}
    finally:
        jx.close()
        pt.close()


def test_engine_device_refuses_a_window_without_kernel():
    app = CSE + "@info(name='q') from cse#window.frequent(2) " \
        "select symbol, price insert into out;"
    with pytest.raises(SiddhiAppCreationError, match="no device kernel"):
        siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_siddhi_app_runtime("@app:engine('device')\n" + app)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
        .create_siddhi_app_runtime(app)
    try:
        (w,) = rt.query_runtimes["q"].windows
        assert type(w).__name__ != "DeviceWindowProcessor"
        assert rt.query_runtimes["q"].backend == "host"
    finally:
        rt.shutdown()


def test_partition_clones_keep_host_windows():
    """A window query inside a host partition clone (the partition falls
    back: no device runtime takes a sort window) keeps the host
    processor (one small device state a key would serialize), as in the
    JAX package."""
    app = CSE + "partition with (symbol of cse) begin @info(name='q') " \
        "from cse#window.sort(2, price) select symbol, price insert into " \
        "out; end;"
    for pkg, kw in ((siddhi_tpu, {}), (siddhi_tpu_torch, {"device": "cpu"})):
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            "@app:playback\n" + app)
        try:
            rt.start()
            rt.get_input_handler("cse").send_batch(
                {"symbol": np.asarray(["A", "B"], object),
                 "price": np.ones(2, np.float32),
                 "volume": np.arange(2)}, timestamps=np.asarray([1, 2]))
            pr = rt.partition_runtimes[0]
            assert not pr.device_mode
            kinds = {type(w).__name__ for inst in pr.instances.values()
                     for qr in inst.query_runtimes.values()
                     for w in qr.windows}
            assert kinds == {"SortWindowProcessor"}, kinds
        finally:
            rt.shutdown()
