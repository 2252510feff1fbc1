"""The port's pattern bank against the JAX package's, on the CPU.

``siddhi_tpu_torch.plan.nfa_compiler.CompiledPatternBank(device="cpu")``
(the plain bank step, ops/nfa.nfa_bank_step_plain) and
``siddhi_tpu.plan.nfa_compiler.CompiledPatternBank`` take the same apps
and the same packed blocks; every block's raw outputs (the per-pattern
counts and the six ring outputs: counts, ring_cnt, ring_pid, ring_caps,
ring_ts, ring_ok, zero-count rows included), every carry leaf after every
block, ``total_dropped`` and the decoded ring must be EQUAL — the JAX
step is bit-exact, so the tolerance is zero (float32 compared by bits).

The grid: stacked and sequential chunks × B in {1, 4}; grow-and-replay
from K = 1; telemetry on; ring 0; a default-sized single chunk.  The
feeds (tests/test_dispatch_stack.py's dense round-robin blocks) include a
tie-heavy block (every lane the same events, so equal counts decide the
ring by lane index), a block whose prices sit exactly on the float32
thresholds, and blocks where fewer lanes match than the ring holds.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from siddhi_tpu.ops.nfa import pack_blocks  # noqa: E402
from siddhi_tpu.plan.nfa_compiler import \
    CompiledPatternBank as JaxBank  # noqa: E402
from siddhi_tpu.utils.errors import \
    SiddhiAppCreationError as JaxCreationError  # noqa: E402
from siddhi_tpu_torch.plan.nfa_compiler import \
    CompiledPatternBank as TorchBank  # noqa: E402
from siddhi_tpu_torch.utils.errors import SiddhiAppCreationError  # noqa: E402

import chip_smoke  # noqa: E402

STREAM = "define stream S (partition int, price float, kind int);\n"
P = 16          # partitions
T = 12          # events per lane per block
BASE = 1_000_000
GAP = 1_000     # per-lane inter-arrival ms
THRS = np.linspace(5.0, 95.0, 8)


def _app(thr, floor=None, within_ms=9_000):
    extra = f" and price > {floor}" if floor is not None else ""
    return (STREAM +
            f"from every e1=S[kind == 0 and price > {thr}] -> "
            f"e2=S[kind == 1 and price > e1.price{extra}] "
            f"within {within_ms} milliseconds "
            "select e1.price as p1, e2.price as p2 insert into Out;")


def _block(rng, t0, feed="random", thrs=THRS):
    """One dense [P, T] block, every lane active, globally time-ordered.

    feed "ties": every lane sees the same prices and kinds (equal counts
    across lanes); "f32": prices drawn from the float32 thresholds and
    their neighbours (compares decided at the float32 boundary)."""
    n = P * T
    pids = np.tile(np.arange(P, dtype=np.int64), T)
    j = np.repeat(np.arange(T, dtype=np.int64), P)
    ts = t0 + j * GAP + pids * (GAP // P)
    price = rng.uniform(0, 100, n).astype(np.float32)
    kind = rng.integers(0, 2, n).astype(np.float32)
    if feed == "ties":
        price = np.repeat(rng.uniform(0, 100, T).astype(np.float32), P)
        kind = np.repeat(rng.integers(0, 2, T).astype(np.float32), P)
    elif feed == "f32":
        f = np.asarray(thrs, np.float32)
        pool = np.concatenate([f, np.nextafter(f, np.float32(0)),
                               np.nextafter(f, np.float32(100))])
        price = rng.choice(pool, n).astype(np.float32)
    cols = {"partition": pids.astype(np.float32), "price": price,
            "kind": kind}
    return pack_blocks(pids, cols, ts, np.zeros(n, np.int32), P,
                       base_ts=BASE)


FEEDS = ("ties", "random", "f32", "random")


def _same(a, b) -> bool:
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.float32:
        return bool((a.view(np.int32) == b.view(np.int32)).all())
    return bool((a == b).all())


def _run_pair(apps, feeds=FEEDS, replayed=False, seed=0, **kw):
    """Both banks over the same blocks; every output, carry leaf and
    decoded ring compared after each block.  → (JAX bank, port bank,
    per-block JAX outputs)."""
    jb = JaxBank(apps, n_partitions=P, **kw)
    tb = TorchBank(apps, n_partitions=P, device="cpu", **kw)
    jb.base_ts = tb.base_ts = BASE
    assert (tb.stacked, tb.n_chunks, tb.chunk, tb.ring) == \
        (jb.stacked, jb.n_chunks, jb.chunk, jb.ring)
    rng = np.random.default_rng(seed)
    t0 = BASE
    outs = []
    for b, feed in enumerate(feeds):
        block = _block(rng, t0, feed)
        t0 += T * GAP
        if replayed:
            jo, to = jb.process_block_replayed(block), \
                tb.process_block_replayed(block)
        else:
            jo, to = jb.process_block(block), tb.process_block(block)
        if not jb.ring:
            jo, to = (jo,), (to,)
        assert len(jo) == len(to)
        for i, (x, y) in enumerate(zip(jo, to)):
            assert _same(x, y), f"block {b} ({feed}) output {i}:\n{x}\n{y}"
        assert tb.nfa.spec.n_slots == jb.nfa.spec.n_slots
        for ci, (jc, tc) in enumerate(zip(jb.carries, tb.carries)):
            assert sorted(jc) == sorted(tc)
            for k in jc:
                assert _same(jc[k], tc[k]), f"block {b} chunk {ci} {k}"
        assert tb.total_dropped() == jb.total_dropped()
        if jb.ring:
            jd, td = jb.decode_ring(*jo[1:]), tb.decode_ring(*to[1:])
            assert list(jd) == list(td)
            for k in jd:
                assert np.array_equal(np.asarray(jd[k]), td[k]), k
        outs.append(tuple(np.asarray(x) for x in jo))
    return jb, tb, outs


@pytest.mark.parametrize("stack", [True, False], ids=["stacked",
                                                      "sequential"])
@pytest.mark.parametrize("B", [1, 4])
def test_bank_equals_jax(stack, B):
    """8 patterns in chunks of 4 (C = 2), ring = P: ties, zero-count ring
    rows and float32-boundary prices all occur, and all agree exactly."""
    _jb, tb, outs = _run_pair([_app(t) for t in THRS], n_slots=4,
                              pattern_chunk=4, ring=P, batch_b=B,
                              stack=stack)
    assert tb.stacked == stack and tb.n_chunks == 2
    counts = np.stack([o[0] for o in outs])
    rcnt = np.stack([o[1] for o in outs])
    assert counts.sum() > 0
    # zero-count partitions fill the ring behind the matched ones
    assert (rcnt == 0).any() and (rcnt > 0).any()
    # the tie block (first, from an empty carry): every lane of a pattern
    # has the same count, so the ring is the lowest lanes in order
    ties = outs[0]
    for n in np.nonzero(ties[0])[0]:
        assert (ties[1][n] == ties[1][n][0]).all()
        assert ties[2][n].tolist() == list(range(P))


def _edge_block(thrs):
    """Lane l arms at its first event with price EDGE[l] — float32(thr_i)
    or its float32 neighbour above — and completes at its second (price
    99.99); its other events are kind 1 at price 0 (no effect)."""
    f = np.asarray(thrs, np.float32)
    edge = np.concatenate([f, np.nextafter(f, np.float32(100))])
    edge = np.resize(edge, P).astype(np.float32)
    n = P * T
    pids = np.tile(np.arange(P, dtype=np.int64), T)
    j = np.repeat(np.arange(T, dtype=np.int64), P)
    ts = BASE + j * GAP + pids * (GAP // P)
    price = np.where(j == 0, edge[pids], np.where(j == 1, 99.99, 0.0))
    kind = (j != 0).astype(np.float32)
    cols = {"partition": pids.astype(np.float32),
            "price": price.astype(np.float32), "kind": kind}
    return edge, pack_blocks(pids, cols, ts, np.zeros(n, np.int32), P,
                             base_ts=BASE)


def test_bank_float32_threshold_boundary():
    """Constants are float32 lanes compared in float32: a price equal to
    float32(thr) does not pass `price > thr`, its float32 neighbour above
    does — in both packages alike."""
    thrs = THRS[1:5]                   # not exact in float32
    assert (np.asarray(thrs, np.float32) != thrs).all()
    apps = [_app(t) for t in thrs]
    jb = JaxBank(apps, n_partitions=P, n_slots=4, ring=4)
    tb = TorchBank(apps, n_partitions=P, n_slots=4, ring=4, device="cpu")
    assert torch.equal(tb.params[0]["__param_1"],
                       torch.from_numpy(np.asarray(thrs, np.float32)))
    edge, block = _edge_block(thrs)
    jo, to = jb.process_block(block), tb.process_block(block)
    for x, y in zip(jo, to):
        assert _same(x, y)
    want = [int((edge > np.float32(t)).sum()) for t in thrs]
    assert to[0].tolist() == want and min(want) > 0


def test_bank_grow_and_replay_equals_jax():
    """K = 1: both banks rewind, double K and replay the same blocks."""
    jb, tb, outs = _run_pair([_app(t) for t in THRS[:4]], n_slots=1,
                             pattern_chunk=2, ring=8, replayable=True,
                             replayed=True, seed=5)
    assert tb.nfa.spec.n_slots > 1 and tb.total_dropped() == 0
    assert sum(int(o[0].sum()) for o in outs) > 0


def test_bank_telemetry_equals_jax():
    """telemetry=True: the carry's per-state telemetry leaf too."""
    _jb, tb, outs = _run_pair([_app(t) for t in THRS[:4]],
                              feeds=("ties", "random"), n_slots=4,
                              pattern_chunk=2, ring=4, telemetry=True)
    assert all("telem" in c for c in tb.carries)
    assert sum(int(o[0].sum()) for o in outs) > 0


def test_bank_counts_only_equals_jax():
    """ring = 0: per-pattern counts alone; a default-sized single chunk
    (analysis/cost_model.default_pattern_chunk)."""
    _jb, tb, outs = _run_pair([_app(t, floor=20.0) for t in THRS[:4]],
                              feeds=("random", "random"), n_slots=4)
    assert tb.n_chunks == 1 and not tb.stacked and tb.ring == 0
    assert sum(int(o[0].sum()) for o in outs) > 0


def test_extract_params_equals_jax():
    """Every numeric filter constant is a parameter lane, in the same
    order and with the same values, in both packages."""
    apps = [_app(t, floor=t / 2) for t in (12.5, 60.0)]
    jb = JaxBank(apps, n_partitions=4, n_slots=2)
    tb = TorchBank(apps, n_partitions=4, n_slots=2, device="cpu")
    assert tb.nfa.param_names == jb.nfa.param_names == \
        [f"__param_{j}" for j in range(4)]
    for a in apps + [_app(7.0, floor=3.0)]:
        assert tb.nfa.extract_params(a) == jb.nfa.extract_params(a)
    assert tb.nfa.extract_params(apps[1]) == {
        "__param_0": 0.0, "__param_1": 60.0, "__param_2": 1.0,
        "__param_3": 30.0}
    with pytest.raises(SiddhiAppCreationError, match="constant count"):
        tb.nfa.extract_params(_app(7.0))
    with pytest.raises(SiddhiAppCreationError, match="chain length"):
        tb.nfa.extract_params(
            STREAM + "from every e1=S[price > 1.0] select e1.price as p "
            "insert into Out;")


REJECTED = {
    "indexed kleene select": (
        STREAM + "from e1=S[kind == 0 and price > 5.0]<2:3> -> "
        "e2=S[kind == 1] select e1[1].price as p1, e2.price as p2 "
        "insert into Out;", "indexed kleene"),
    "string condition": (
        "define stream S (partition int, price float, sym string);\n"
        "from every e1=S[sym == 'a' and price > 5.0] -> e2=S[price > "
        "e1.price] select e1.price as p1 insert into Out;",
        "string conditions"),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_bank_rejections_match_jax(name):
    app, word = REJECTED[name]
    with pytest.raises(JaxCreationError, match=word):
        JaxBank([app], n_partitions=4, n_slots=2)
    with pytest.raises(SiddhiAppCreationError, match=word):
        TorchBank([app], n_partitions=4, n_slots=2, device="cpu")


def test_chip_smoke_bank_reference_equals_jax_bank():
    """chip_smoke.py phase 8's independent numpy reference (per-pattern
    counts from the lane streams) equals the JAX bank's counts on its own
    generator, and every ring row the port decodes passes its check."""
    thrs = np.linspace(5.0, 95.0, 8)
    apps = [chip_smoke.bank_app(t, floor=20.0, within_ms=4 * GAP)
            for t in thrs]
    jb = JaxBank(apps, n_partitions=P, n_slots=8, ring=8)
    tb = TorchBank(apps, n_partitions=P, n_slots=8, ring=8, device="cpu")
    jb.base_ts = tb.base_ts = chip_smoke.BANK_BASE_TS
    raw = chip_smoke.bank_blocks(np.random.default_rng(3), 3, P=P, T=T,
                                 gap=GAP)
    want, price, kind = chip_smoke.bank_reference(raw, thrs, floor=20.0,
                                                  gap=GAP, within_ms=4 * GAP)
    counts = np.zeros(len(thrs), np.int64)
    rows = 0
    for block in raw:
        jo, to = jb.process_block(block), tb.process_block(block)
        counts += np.asarray(jo[0], np.int64)
        rows += chip_smoke.check_ring_rows(tb.decode_ring(*to[1:]), price,
                                           kind, thrs, floor=20.0, gap=GAP,
                                           within_ms=4 * GAP)
    assert jb.total_dropped() == 0
    assert counts.tolist() == want.tolist() and want.sum() > 0 and rows > 0


def test_bank_template_holds_no_carry():
    """The bank's parameterized compile is a template: the bank holds the
    carries and builds its own step, so the template allocates neither,
    and growing the bank's slots widens only the bank's carries."""
    bank = TorchBank([_app(t) for t in THRS], n_partitions=P, n_slots=2,
                     pattern_chunk=4, ring=4, device="cpu")
    assert bank.nfa.carry is None and bank.nfa._step is None
    bank.grow_slots(4)
    assert bank.nfa.spec.n_slots == 4 and bank.nfa.carry is None
    assert all(c["slot_state"].shape[-1] == 4 for c in bank.carries)
    with pytest.raises(SiddhiAppCreationError, match="no carry"):
        bank.nfa.grow(2 * P)


SIG = "(anonymous namespace)::StepArgs)"


@pytest.mark.parametrize("key,name,want", [
    ("void (anonymous namespace)::nfa_step_kernel<1>(" + SIG,
     "nfa_step_kernel", True),
    ("void (anonymous namespace)::nfa_bank_step_kernel<1>(" + SIG,
     "nfa_step_kernel", False),
    ("void (anonymous namespace)::nfa_bank_step_kernel<4>(" + SIG,
     "nfa_bank_step_kernel", True),
    ("(anonymous namespace)::nfa_bank_ring_kernel((anonymous namespace)"
     "::RingArgs)", "nfa_bank_ring_kernel", True),
    ("(anonymous namespace)::nfa_compact_kernel((anonymous namespace)"
     "::PackArgs)", "nfa_step_kernel", False),
])
def test_chip_smoke_splits_device_time_by_exact_kernel_name(key, name, want):
    """chip_smoke.py's device splits keep the pattern step and the bank
    step apart, although one name holds the other's tail."""
    assert chip_smoke.is_kernel(key, name) is want


def test_chip_smoke_max_abs_diff():
    """The error chip_smoke.py reports for the bank kernels: the largest
    |a - b| over a tensor, slice by slice, NaN against NaN and equal
    infinities counting 0."""
    a = torch.tensor([[1.0, float("nan")], [float("inf"), 2.0]])
    b = a.clone()
    assert chip_smoke._max_abs_diff(a, b) == 0.0
    b[1, 1] = 2.5
    assert chip_smoke._max_abs_diff(a, b) == 0.5
    i = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    j = i.clone()
    j[2, 3] -= 7
    assert chip_smoke._max_abs_diff(i, j) == 7.0
    m = torch.zeros(5, dtype=torch.bool)
    assert chip_smoke._max_abs_diff(m, m) == 0.0
    assert chip_smoke._max_abs_diff(m, ~m) == 1.0
    assert chip_smoke._max_abs_diff(i, i.float()) == float("inf")
