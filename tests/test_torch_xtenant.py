"""The torch port's cross-tenant packer vs the JAX package's.

The gang itself: the same heterogeneous tenants (different thresholds,
block lengths T, kleene-count and absent tenants, one tenant whose slot
ring overflows) and the same numpy blocks, made from a seed, go through
the JAX package's gang (``plan/xtenant._build_gang``: every tenant's
block step and egress pack in one jitted function, on the CPU) and
through the port's ``nfa_gang_step_egress_plain``.  Every carry leaf
and every egress row must be equal BIT for bit (both run the same
float32/int32 compares, selects and copies in the same order); a
tenant with no pending block is not stepped.  ``nfa_gang_step_egress``
on CPU tensors is the plain twin, and each tenant's result is the one
``nfa_step_egress`` gives it alone.

Through the public API (``SiddhiManager``, ``send_batch``, callbacks,
``shutdown``) both packages pack the same apps into the same buckets
with the same labels and packer rows, and emit the same rows: a
tenant that overflows rewinds and grows alone, a tenant shut down
mid-stream is evicted without touching its co-tenants, and
``SIDDHI_TPU_XTENANT=0`` turns packing off with the rows unchanged.
"""
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.plan.nfa_compiler import CompiledPatternNFA as JaxNFA
from siddhi_tpu.plan.xtenant import _build_gang as jax_build_gang
from siddhi_tpu_torch.ops.nfa import (GangTenant, nfa_gang_step_egress,
                                      nfa_gang_step_egress_plain,
                                      nfa_step_egress)
from siddhi_tpu_torch.ops.pack import pack_blocks
from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA

STREAM = "define stream S (k int, v float);\n"

#: tenants of one shape class each (S, K, P, B and the capture geometry
#: shared within a group): thresholds differ, and one tenant of the
#: simple group never closes its partials, so its slot ring overflows
GROUPS = {
    "simple": [
        STREAM + "from every e1=S[v > 0.1] -> e2=S[v > e1.v] "
        "select e1.v as a, e2.v as b insert into Out;",
        STREAM + "from every e1=S[v > 0.5] -> e2=S[v > e1.v] "
        "select e1.v as a, e2.v as b insert into Out;",
        STREAM + "from every e1=S[v > 0.8] -> e2=S[v > e1.v] within 30 "
        "select e1.v as a, e2.v as b insert into Out;",
        STREAM + "from every e1=S[v > 0.0] -> e2=S[v > 0.995] "
        "select e1.v as a, e2.v as b insert into Out;",
    ],
    "count": [
        STREAM + f"from every e1=S[v > {t}] -> e2=S[v > e1.v]<1:3> -> "
        "e3=S[v < e2[last].v] within 40 select e1.v as a, "
        "e2[last].v as b, e3.v as c insert into Out;"
        for t in (0.2, 0.6)
    ],
    "absent": [
        STREAM + f"from every e1=S[v > {t}] -> not S[v > e1.v] for 25 "
        "select e1.v as a insert into Out;"
        for t in (0.3, 0.7, 0.9)
    ],
}
P, K, CAP = 16, 4, 64
#: events a block per tenant: the tenants' T differ
N_EVENTS = (40, 90, 17, 64, 33)


def _flat(rng, n, t0):
    return (rng.integers(0, P, n).astype(np.int64),
            {"v": rng.uniform(0.0, 1.0, n).astype(np.float32),
             "k": rng.integers(0, 4, n).astype(np.float32)},
            t0 + np.cumsum(rng.integers(0, 3, n)).astype(np.int64))


def _block(nfa, rng, n, t0):
    pids, cols, ts = _flat(rng, n, t0)
    return pack_blocks(pids, {a: cols[a] for a in nfa.attr_names}, ts,
                       np.zeros(n, np.int32), P, base_ts=t0)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and a.dtype == b.dtype and \
        bool(np.array_equal(a, b))


def _pair(app):
    jx = JaxNFA(app, n_partitions=P, n_slots=K, mesh=None)
    pt = CompiledPatternNFA(app, n_partitions=P, n_slots=K, device="cpu")
    return jx, pt


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_gang_plain_equals_jax_gang(group):
    """Three chained flushes of one bucket; in the second one tenant has
    no pending block.  Carries and egress rows bit for bit."""
    pairs = [_pair(a) for a in GROUPS[group]]
    for i, (jx, _pt) in enumerate(pairs):
        jx._xt_id = i
        jx._egress_cap = CAP
    rng = np.random.default_rng(7)
    jcar = [jx.carry for jx, _ in pairs]
    pcar = [pt.carry for _, pt in pairs]
    dropped = np.zeros(len(pairs), np.int64)
    matches = 0
    gangs = {}
    for flush in range(3):
        idle = 1 if flush == 1 else -1          # no pending block
        live = [i for i in range(len(pairs)) if i != idle]
        blocks = {i: _block(pairs[i][1], rng,
                            N_EVENTS[(i + flush) % len(N_EVENTS)],
                            100 * flush) for i in live}
        if tuple(live) not in gangs:
            gangs[tuple(live)] = jax_build_gang([pairs[i][0] for i in live])
        gang, _caps = gangs[tuple(live)]
        jout = gang([jcar[i] for i in live], [blocks[i] for i in live])
        news, ge = nfa_gang_step_egress_plain(
            [GangTenant(pairs[i][1].spec, pcar[i],
                        pairs[i][1].to_device(blocks[i]), pairs[i][1].kprog,
                        CAP) for i in live])
        assert list(ge.offsets) == [j * (CAP + 2) for j in range(len(live))]
        for j, i in enumerate(live):
            nc, buf, _outs, _tele = jout[j]
            assert set(nc) == set(news[j])
            for leaf in nc:
                assert _same(nc[leaf], news[j][leaf]), (group, i, leaf)
            got = ge.egress[j].buf.numpy()
            assert got.shape == (CAP + 2, buf.shape[1])
            assert _same(np.asarray(buf), got[:CAP + 1]), (group, i)
            assert _same(got, ge.buf.numpy()[j * (CAP + 2):
                                             (j + 1) * (CAP + 2)])
            matches += int(np.asarray(buf)[CAP, 0])
            dropped[i] = int(np.asarray(nc["dropped"]).sum())
            jcar[i], pcar[i] = nc, news[j]
    assert matches > 0
    if group == "simple":
        # the greedy tenant's ring overflowed most
        assert dropped[3] > dropped[:3].max(), dropped


def test_gang_wrapper_equals_each_tenant_alone():
    """On CPU tensors the gang wrapper is the plain twin, and each
    tenant's carry and egress equal ``nfa_step_egress`` of it alone;
    a tenant's repack compacts that tenant only, at another cap."""
    nfas = [_pair(a)[1] for a in GROUPS["simple"]]
    rng = np.random.default_rng(3)
    tenants = [GangTenant(n.spec, n.carry, n.to_device(
        _block(n, rng, N_EVENTS[i], 0)), n.kprog, 8 + 8 * i)
        for i, n in enumerate(nfas)]
    news, ge = nfa_gang_step_egress(tenants)
    assert ge.buf.shape[0] == sum(t.cap + 2 for t in tenants)
    for t, new, eg in zip(tenants, news, ge.egress):
        alone, eg1 = nfa_step_egress(t.spec, t.carry, t.block, t.kprog,
                                     t.cap)
        for leaf in alone:
            assert torch.equal(alone[leaf], new[leaf])
        assert torch.equal(eg1.buf, eg.buf)
        assert torch.equal(eg1.repack(2 * t.cap), eg.repack(2 * t.cap))


# ------------------------------------------------------------ public API

def _app(i, thr, e2="v > e1.v"):
    return (f"@app:name('xt{i}') @app:pipeline('4') "
            "define stream S (k int, v double); "
            f"@info(name='q') from every e1=S[v > {thr}] -> "
            f"e2=S[{e2}] select e1.v as a, e2.v as b insert into Out;")


def _run(pkg, apps, seed, monkeypatch, packed, walls=4, events=12,
         kill=None, cap=None):
    """Round-robin ``walls`` blocks per app; returns (per-app sorted
    rows, per-app (K, bucket label), this run's packer rows)."""
    monkeypatch.setenv("SIDDHI_TPU_XTENANT", "1" if packed else "0")
    if cap is not None:
        monkeypatch.setenv("SIDDHI_TPU_XTENANT_BUCKET", str(cap))
    kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    m = pkg.SiddhiManager(**kw)
    rows = [[] for _ in apps]
    rts = []
    for i, a in enumerate(apps):
        rt = m.create_siddhi_app_runtime(a)
        rt.add_callback("Out", pkg.StreamCallback(
            lambda evs, _r=rows[i]: _r.extend(tuple(e.data) for e in evs)))
        rt.start()
        rts.append(rt)
    rng = np.random.default_rng(seed)
    t0 = 1_000_000
    try:
        for w in range(walls):
            for rt in rts:
                v = rng.uniform(0.0, 1.0, events)
                if rt is None:
                    continue
                rt.get_input_handler("S").send_batch(
                    {"k": np.arange(events, dtype=np.int64) % 4, "v": v},
                    timestamps=t0 + np.arange(events, dtype=np.int64))
            t0 += events
            if kill is not None and w == kill[0]:
                rts[kill[1]].shutdown()
                rts[kill[1]] = None
        shapes = []
        for rt in rts:
            if rt is None:
                shapes.append(None)
                continue
            rt.flush()
            nfa = next(iter(rt.query_runtimes.values())).device_runtime.nfa
            b = getattr(nfa, "_tenant_bucket", None)
            shapes.append((nfa.spec.n_slots, b.label if b else None))
        from importlib import import_module
        snap = import_module(pkg.__name__ + ".plan.xtenant") \
            .tenant_packer().snapshot()
        mine = [b for b in snap["buckets"]
                if any(t.startswith("xt") for t in b["tenants"])]
    finally:
        m.shutdown()
    return [sorted(r) for r in rows], shapes, mine


@pytest.fixture(autouse=True)
def _mesh_off(monkeypatch):
    # the JAX package packs single-device automata only
    monkeypatch.setenv("SIDDHI_TPU_MESH", "off")


def test_bucket_membership_labels_and_rows_equal_jax(monkeypatch):
    """Six tenants under a bucket cap of 4: two buckets, the same
    labels, members and counters as the JAX package's; rows equal."""
    apps = [_app(i, 0.1 * (i % 5)) for i in range(6)]
    jr, js, jb = _run(siddhi_tpu, apps, 5, monkeypatch, True, cap=4)
    pr, ps, pb = _run(siddhi_tpu_torch, apps, 5, monkeypatch, True, cap=4)
    assert pr == jr and sum(map(len, pr)) > 0
    assert ps == js
    assert [b["bucket"] for b in pb] == [b["bucket"] for b in jb] == \
        ["S2K8P1B4", "S2K8P1B4"]
    for a, b in zip(pb, jb):
        assert a == b
    assert [len(b["tenants"]) for b in pb] == [4, 2]


def test_overflowing_tenant_rewinds_alone(monkeypatch):
    """A greedy tenant overflows its K = 8 ring: only it rewinds, grows
    and replays, re-keyed into a bucket of its own; rows equal the
    unpacked run's and the JAX package's."""
    apps = [_app(0, 0.0, e2="v > 0.97"), _app(1, 0.2)]
    pr, ps, pb = _run(siddhi_tpu_torch, apps, 3, monkeypatch, True,
                      walls=5)
    ur, us, _ = _run(siddhi_tpu_torch, apps, 3, monkeypatch, False,
                     walls=5)
    jr, js, jb = _run(siddhi_tpu, apps, 3, monkeypatch, True, walls=5)
    assert ps[0][0] > 8 and us[0][0] == ps[0][0]
    assert ps[0][1] != ps[1][1], "slot growth did not re-key the tenant"
    assert pr == ur == jr and sum(map(len, pr)) > 0
    assert ps == js and pb == jb and len(pb) == 2


def test_shutdown_evicts_without_disturbing_cotenants(monkeypatch):
    apps = [_app(i, 0.1 * i) for i in range(3)]
    pr, _, pb = _run(siddhi_tpu_torch, apps, 5, monkeypatch, True,
                     walls=5, kill=(2, 1))
    ur, _, _ = _run(siddhi_tpu_torch, apps, 5, monkeypatch, False,
                    walls=5, kill=(2, 1))
    jr, _, jb = _run(siddhi_tpu, apps, 5, monkeypatch, True, walls=5,
                     kill=(2, 1))
    assert pr == ur == jr and len(pr[0]) > 0 and len(pr[2]) > 0
    assert sorted(t for b in pb for t in b["tenants"]) == ["xt0/q", "xt2/q"]
    assert pb == jb


def test_kill_switch_unpacks_with_equal_rows(monkeypatch):
    from siddhi_tpu_torch.plan.xtenant import resolve_xtenant
    apps = [_app(i, 0.2 * i) for i in range(3)]
    pr, ps, pb = _run(siddhi_tpu_torch, apps, 9, monkeypatch, True)
    ur, us, ub = _run(siddhi_tpu_torch, apps, 9, monkeypatch, False)
    assert resolve_xtenant() is False          # the switch is still off
    assert pr == ur and sum(map(len, pr)) > 0
    assert all(s[1] is not None for s in ps) and len(pb) == 1
    assert all(s[1] is None for s in us) and ub == []


def test_gang_flush_writes_compile_rows_and_counts(monkeypatch):
    """The gang's shape class ``nfa.xstep`` gets a compile row on its
    first call (``build``, then ``rebucket`` for a new signature), and
    the profiler counts one dispatch a flush."""
    from siddhi_tpu_torch.core.profiling import profiler
    from siddhi_tpu_torch.plan.shapes import shape_registry
    prof = profiler()
    was = prof.enabled
    prof.enable()
    try:
        d0 = prof.stats("nfa.xstep").dispatch_count
        _run(siddhi_tpu_torch, [_app(i, 0.3) for i in range(3)], 2,
             monkeypatch, True, walls=3)
        assert prof.stats("nfa.xstep").dispatch_count - d0 >= 3
    finally:
        if not was:
            prof.disable()
    snap = shape_registry().snapshot()
    kinds = {e["kind"] for e in snap["entries"]} \
        if "entries" in snap else set(str(snap))
    assert any("nfa.xstep" in k for k in kinds)
