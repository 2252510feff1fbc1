"""The pattern bank's CUDA kernels, held on the CPU through their models.

csrc/nfa_step.cu's bank step and match ring cannot run here (no card, no
nvcc); what they compute is held by models of their inputs and their
arithmetic:

- the CPU model of the bank step (ops/nfa.bank_lanes_plain with the
  kernel program: each condition is its block-wide gate bit, shared by
  every pattern, AND its ``<event lane> <cmp> <pattern constant>``
  compares AND its ``<event lane> <cmp> <capture lane>`` compares) equals
  the plain bank step, carry and per-lane outputs, on in-class specs;
- the program table the kernel parses recovers both compare tables;
- the CPU model of the ring kernel (ops/nfa.bank_ring_model: the row in
  shared-memory tiles, the ring-th largest count by bisection with
  per-warp counts, ballot compaction in lane order, the tiles' lists
  merged) selects the lanes of the stable descending sort on tie-heavy
  counts, rows that are not a multiple of 32, rows tiled, ring 0 and
  ring = P; it equals the plain ring and the JAX package's lax.top_k ring
  bit for bit; its shared-memory sizing stays under 227 KB;
- the CPU model of the bank step's thread instance (ops/nfa.
  bank_thread_model: one thread per (pattern, lane), an event live for
  it when it passes, after the CTA's union and its own constant
  intervals, a condition its slots or unit 0 need — those of the units
  its slots wait at and of the counts they append to, with absent or
  count units — a live event the plain step's order, a dead one only
  `within` on the live slots and the deadline pass) equals the plain
  bank step bit for bit, carry and per-lane outputs, on every spec at K
  = 1, 5, 8 and 16 — kleene counts (config 4's leading count, a
  mid-chain count, a count whose [last] bank the next unit reads, a
  count after an absent unit) and condition programs (the Quick start's
  ratio, a count's own [last] guard) among them — and on blocks whose
  timestamps go backwards in a lane, whose padded events would expire
  or match, whose offsets wrap int32 across `within`, whose events are
  all dead while partials live, and whose T is ragged; the JAX bank
  agrees with it on those blocks and on the count and ratio banks;
- the intervals equal the six compares on IEEE special values;
- the instance choice and shared-memory sizing stay under the CTA's
  227 KB wherever they pick the thread instance, which takes the count
  and program banks; K = 17, nine constant compares and a column past
  shared memory go to the group instance;
- a bank outside the kernel's class (the single-pattern step's: a
  transcendental here) is refused on CUDA before any device memory is
  touched, naming the feature;
- ``import siddhi_tpu_torch`` and the bank leave jax out.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from siddhi_tpu.plan.nfa_compiler import \
    CompiledPatternBank as JaxBank  # noqa: E402
from siddhi_tpu_torch.ops.nfa import (BANK_GROUPS, CMP_OPS,  # noqa: E402
                                      PROG_HEADER, SMEM_LIMIT, UNIT_WORDS,
                                      WIDE_HEADER, WIDE_UNIT_WORDS,
                                      bank_class_reason, bank_geometry,
                                      bank_lanes_plain, bank_ring_model,
                                      bank_ring_plain, bank_thread_model,
                                      kernel_prog, nfa_bank_step,
                                      nfa_bank_step_plain, pcmp_bounds,
                                      ring_geometry, ring_layout_ints)
from siddhi_tpu_torch.ops.pack import pack_blocks  # noqa: E402
from siddhi_tpu_torch.plan.nfa_compiler import \
    CompiledPatternBank  # noqa: E402
from siddhi_tpu_torch.utils.errors import SiddhiAppCreationError  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = "define stream S (partition int, price float, kind int);\n"
P, T, BASE, GAP = 16, 12, 1_000_000, 1_000

#: in-class bank shapes: {name: (app template over {a}, {b}, values)}
SPECS = {
    # bench.py's headline pattern
    "alert": (STREAM + "from every e1=S[kind == 0 and price > {a}] -> "
              "e2=S[kind == 1 and price > e1.price and price > {b}] "
              "within 9000 milliseconds select e1.price as p1, e2.price "
              "as p2 insert into Out;",
              [(t, 20.0) for t in np.linspace(5, 95, 6)]),
    # constants on the left (mirrored), <=, >=, !=, a 3-unit chain
    "chain3": (STREAM + "from every e1=S[{a} <= price and kind != 1] -> "
               "e2=S[kind == 1 and price >= e1.price] -> e3=S[price < {b} "
               "and price < e2.price] within 9 sec select e1.price as p1, "
               "e3.price as p3 insert into Out;",
               [(t, 80.0 - t / 2) for t in np.linspace(10, 60, 4)]),
    # no `every`: single-shot arming (armed_total)
    "no_every": (STREAM + "from e1=S[kind == 0 and price > {a}] -> "
                 "e2=S[kind == {b} and price > e1.price] select e1.price "
                 "as p1, e2.price as p2 insert into Out;",
                 [(t, 1) for t in np.linspace(5, 95, 4)]),
    # one unit: arming completes the match (the arm-match path)
    "one_unit": (STREAM + "from every e1=S[price > {a} and kind == {b}] "
                 "select e1.price as p1 insert into Out;",
                 [(t, k) for t in (30.0, 70.0) for k in (0, 1)]),
    # a trailing absent unit reading a capture (BASELINE config 3's
    # pattern): kills, deadlines, the deadline pass on dead events
    "absent": (STREAM + "from every e1=S[kind == 0 and price > {a}] -> "
               "e2=S[kind == 1 and price > e1.price and price > {b}] -> "
               "not S[kind == 0 and price > e2.price] for 3 sec within "
               "9000 milliseconds select e1.price as p1, e2.price as p2 "
               "insert into Out;",
               [(t, 20.0) for t in np.linspace(5, 95, 6)]),
    # a mid-chain absent unit, armed into straight from unit 0
    "absent_mid": (STREAM + "from every e1=S[kind == 0 and price > {a}] -> "
                   "not S[kind == 1 and price < {b}] for 2 sec -> "
                   "e3=S[kind == 1 and price > e1.price] within 9 sec "
                   "select e1.price as p1, e3.price as p3 insert into Out;",
                   [(t, 50.0 - t / 4) for t in np.linspace(10, 80, 4)]),
}


def _block(rng, t0):
    n = P * T
    pids = np.tile(np.arange(P, dtype=np.int64), T)
    j = np.repeat(np.arange(T, dtype=np.int64), P)
    ts = t0 + j * GAP + pids * (GAP // P)
    cols = {"partition": pids.astype(np.float32),
            "price": rng.uniform(0, 100, n).astype(np.float32),
            "kind": rng.integers(0, 2, n).astype(np.float32)}
    return pack_blocks(pids, cols, ts, np.zeros(n, np.int32), P,
                       base_ts=BASE)


def _bank(name, **kw):
    text, vals = SPECS[name]
    apps = [text.format(a=a, b=b) for a, b in vals]
    kw.setdefault("pattern_chunk", len(apps) // 2)
    return CompiledPatternBank(apps, n_partitions=P, n_slots=4, ring=8,
                               device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_kernel_model_equals_plain(name):
    """The bank step from the kernel's inputs (gate word, constant
    compares, capture compares) equals the plain bank step over chained
    blocks: every carry leaf, per-lane count, last-match ts and slot."""
    bank = _bank(name)
    kp = bank.nfa.kprog
    assert kp.reason is None, kp.reason
    assert any(kp.pcmp) and kp.param_names == tuple(bank.nfa.param_names)
    spec = bank.nfa.spec
    params = bank._stack_params
    rng = np.random.default_rng(7)
    c_plain = c_model = bank._stack_carry
    total = 0
    for b in range(3):
        block = bank.nfa.to_device(_block(rng, BASE + b * T * GAP))
        want = bank_lanes_plain(spec, c_plain, block, params)
        got = bank_lanes_plain(spec, c_model, block, params, kprog=kp)
        for k in want[0]:
            assert torch.equal(got[0][k], want[0][k]), (b, k)
        for x, y in zip(got[1:], want[1:]):
            assert torch.equal(x, y), b
        c_plain, c_model = want[0], got[0]
        total += int(want[1].sum())
    assert total > 0


def _kbank(name, K, **kw):
    text, vals = SPECS[name]
    apps = [text.format(a=a, b=b) for a, b in vals]
    return CompiledPatternBank(apps, n_partitions=P, n_slots=K,
                               pattern_chunk=len(apps) // 2, device="cpu",
                               **kw)


def _model_vs_plain(bank, blocks, cta_patterns=8):
    """The thread model and the plain bank step over chained blocks,
    equal bit for bit after each: every carry leaf, count, lmt, lmk.
    → (final carry, per-block lane counts)."""
    spec, kp, prm = bank.nfa.spec, bank.nfa.kprog, bank._stack_params
    assert kp.reason is None, kp.reason
    c_plain = c_model = bank._stack_carry
    counts = []
    for b, raw in enumerate(blocks):
        block = bank.nfa.to_device(raw)
        want = bank_lanes_plain(spec, c_plain, block, prm)
        got = bank_thread_model(spec, c_model, block, prm, kp,
                                cta_patterns)
        for k in want[0]:
            assert torch.equal(got[0][k], want[0][k]), (b, k)
        for x, y in zip(got[1:], want[1:]):
            assert torch.equal(x, y), b
        c_plain, c_model = want[0], got[0]
        counts.append(got[1])
    return c_model, counts


@pytest.mark.parametrize("K", [1, 5, 8, 16])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_thread_model_equals_plain(name, K):
    """The thread instance's loop equals the plain bank step over three
    chained random blocks (K = 1 and 5 drop partials, K = 16 is the
    largest register instance), with CTAs of 32 patterns (4 groups of 8,
    the fleet's) at K = 8 and of 8 else: the CTA's union of constant
    intervals loses no event."""
    rng = np.random.default_rng(7)
    bank = _kbank(name, K)
    _c, counts = _model_vs_plain(
        bank, [_block(rng, BASE + b * T * GAP) for b in range(3)],
        32 if K == 8 else 8)
    assert sum(int(c.sum()) for c in counts) > 0


def _raw_block(ts, price, kind, valid):
    """A [P, T'] block straight from its lanes (offsets already int32)."""
    return {"partition": np.broadcast_to(
                np.arange(ts.shape[0], dtype=np.float32)[:, None],
                ts.shape).copy(),
            "price": price.astype(np.float32),
            "kind": kind.astype(np.float32),
            "__ts": ts.astype(np.int64).astype(np.int32),
            "__stream": np.zeros(ts.shape, np.int32),
            "__valid": valid.astype(bool)}


def _special_blocks(case, rng):
    """Chained blocks of one special case (offsets from BASE)."""
    def lanes(t0, T_, gap=GAP):
        j = np.arange(T_, dtype=np.int64)[None, :]
        p = np.arange(P, dtype=np.int64)[:, None]
        return t0 + j * gap + p * (gap // P)

    def feed(T_):
        return (rng.uniform(0, 100, (P, T_)), rng.integers(0, 2, (P, T_)),
                np.ones((P, T_), bool))
    out = []
    if case == "backwards":            # each lane's events out of order
        for b in range(3):
            ts = lanes(b * T * GAP, T)
            ts = np.take_along_axis(ts, rng.permuted(
                np.tile(np.arange(T), (P, 1)), axis=1), axis=1)
            out.append(_raw_block(ts, *feed(T)))
    elif case == "padded":             # invalid events that would expire
        for b in range(3):             # or match if they were valid
            price, kind, _v = feed(T)
            n = rng.integers(0, T + 1, P)
            valid = np.arange(T)[None, :] < n[:, None]
            ts = lanes(b * T * GAP, T)
            ts = np.where(valid, ts, ts + rng.integers(0, 40_000, (P, T)))
            price = np.where(valid, price, 99.0)
            out.append(_raw_block(ts, price, kind, valid))
    elif case == "wrap":               # offsets cross 2**31 mid-block
        t0 = 2 ** 31 - 20 * GAP
        for b in range(3):
            out.append(_raw_block(lanes(t0 + b * T * GAP, T), *feed(T)))
    elif case == "all_dead":           # partials live, every event dead:
        out.append(_raw_block(lanes(0, T), *feed(T)))    # only expiry
        ts = lanes(T * GAP, T, gap=2 * GAP)
        out.append(_raw_block(ts, np.full((P, T), np.nan),
                              np.zeros((P, T)), np.ones((P, T), bool)))
    elif case == "ragged":             # T of 7, then 1, then 5
        t0 = 0
        for T_ in (7, 1, 5):
            out.append(_raw_block(lanes(t0, T_), *feed(T_)))
            t0 += T_ * GAP
    return out


SPECIAL = ["backwards", "padded", "wrap", "all_dead", "ragged"]


@pytest.mark.parametrize("case", SPECIAL)
@pytest.mark.parametrize("name", ["alert", "chain3", "no_every"])
def test_thread_model_special_blocks(name, case):
    """Blocks that the dead-event fast path must get right: expiry at
    every event (dead ones and padded ones included) in event order."""
    rng = np.random.default_rng(SPECIAL.index(case))
    bank = _kbank(name, 8)
    blocks = _special_blocks(case, rng)
    c0 = bank._stack_carry
    carry, counts = _model_vs_plain(bank, blocks)
    if case == "all_dead":
        # the first block leaves partials, the second only expires them
        live0 = _model_vs_plain(bank, blocks[:1])[0]["slot_state"] >= 1
        assert int(live0.sum()) > 0 or name == "no_every"
        assert int(counts[1].sum()) == 0
        assert int((carry["slot_state"] >= 1).sum()) < int(live0.sum()) \
            or name == "no_every"
    if case == "wrap":
        assert any((b["__ts"] < 0).any() and (b["__ts"] > 0).any()
                   for b in blocks)
    assert not torch.equal(carry["slot_start"], c0["slot_start"])


@pytest.mark.parametrize("case", ["backwards", "padded", "wrap", "all_dead"])
def test_thread_model_equals_jax_bank(case):
    """The JAX bank on the same special blocks: per-pattern counts after
    every block and the final carry equal the thread model's."""
    rng = np.random.default_rng(SPECIAL.index(case))
    tb = _kbank("alert", 8)
    text, vals = SPECS["alert"]
    jb = JaxBank([text.format(a=a, b=b) for a, b in vals], n_partitions=P,
                 n_slots=8, pattern_chunk=len(vals) // 2)
    assert jb.stacked and tb.stacked
    carry, counts = _model_vs_plain(tb, _special_blocks(case, rng))
    for b, raw in enumerate(_special_blocks(case,
                                            np.random.default_rng(
                                                SPECIAL.index(case)))):
        jc = np.asarray(jb.process_block(raw))
        assert jc.tolist() == counts[b].sum(dim=1).tolist(), b
    for ci, jcar in enumerate(jb.carries):
        for k in jcar:
            x = np.asarray(jcar[k])
            y = carry[k][ci].numpy()
            assert x.dtype == y.dtype and np.array_equal(
                x.view(np.int32), y.view(np.int32)), (ci, k)


#: the count and program banks the thread instance takes: {name: (app
#: template over {a}, {b}, values)}
COUNT_SPECS = {
    # chip_smoke.count_bank_app: a mid-chain count reading e1's capture,
    # its [last] bank read by the next unit
    "count bank": (STREAM + "from every e1=S[kind == 0 and price > {a}] -> "
                   "e2=S[kind == 1 and price > e1.price]<2:3> -> e3=S[kind "
                   "== 0 and price < e2[last].price] within {b} "
                   "milliseconds select e1.price as p1, e2[last].price as "
                   "p2 insert into Out;",
                   [(t, 9000) for t in np.linspace(5, 95, 6)]),
    # BASELINE config 4 as a bank: a leading count (state 0 accumulates,
    # the occupancy gate holds arming), its [last] read by e2
    "config 4": (STREAM + "from every e1=S[kind == 0 and price > {a}]<3:10> "
                 "-> e2=S[kind == 1 and price > e1[last].price] within {b} "
                 "sec select e1[0].price as p0, e1[last].price as pl, "
                 "e2.price as p2 insert into Out;",
                 [(t, 10) for t in np.linspace(0, 60, 6)]),
    # a mid-chain count reading no capture, its closing unit a constant
    "mid-chain count": (STREAM + "from every e1=S[kind == 0 and price > "
                        "{a}] -> e2=S[kind == 1]<2:4> -> e3=S[kind == 0 and "
                        "price > {b}] within 9 sec select e1.price as p1, "
                        "e3.price as p3 insert into Out;",
                        [(t, 100 - t) for t in np.linspace(10, 80, 4)]),
    # a leading count of min 1 (armed forwarded: live appends while e2
    # waits), e2 reading its [last] bank
    "count last read": (STREAM + "from every e1=S[kind == 0 and price > "
                        "{a}]<1:3> -> e2=S[kind == 1 and price > "
                        "e1[last].price and price > {b}] within 9 sec "
                        "select e1[last].price as pl, e2.price as p2 insert "
                        "into Out;",
                        [(t, 30.0) for t in np.linspace(5, 95, 4)]),
    # an absent unit, then a count whose [last] bank the next unit reads:
    # the count instance with deadlines
    "count absent": (STREAM + "from every e1=S[kind == 0 and price > {a}] -> "
                     "not S[kind == 1 and price > {b}] for 1 sec -> "
                     "e2=S[kind == 1 and price > e1.price]<1:3> -> "
                     "e3=S[kind == 0 and price < e2[last].price] within 9 "
                     "sec select e1.price as p1, e2[last].price as p2 "
                     "insert into Out;",
                     [(t, 90.0) for t in np.linspace(5, 95, 4)]),
    # the README's Quick start (`price > e1.price * ratio`): a program
    # reading a capture and a pattern constant
    "ratio": (STREAM + "from every e1=S[kind == 0 and price > {a}] -> "
              "e2=S[kind == 1 and price > e1.price * {b}] within 10 sec "
              "select e1.price as p1, e2.price as p2 insert into Out;",
              [(round(float(t), 3), round(float(r), 4)) for t, r in
               zip(np.linspace(5, 95, 6), np.linspace(1.0, 1.1, 6))]),
    # a count whose own condition is a program over its [last] bank with
    # the nullable guard
    "own last": (STREAM + "from every e1=S[kind == 0 and price > {a}] -> "
                 "e2=S[kind == 1 and (e2[last].price is null or price > "
                 "e2[last].price)]<1:3> -> e3=S[kind == 0 and price > {b}] "
                 "within 5 sec select e1.price as p1, e2[last].price as l2 "
                 "insert into Out;",
                 [(t, 50.0) for t in np.linspace(5, 95, 4)]),
}


def _cbank(name, K, **kw):
    text, vals = COUNT_SPECS[name]
    apps = [text.format(a=a, b=b) for a, b in vals]
    return CompiledPatternBank(apps, n_partitions=P, n_slots=K,
                               pattern_chunk=len(apps) // 2, device="cpu",
                               **kw)


def test_count_and_program_banks_route_to_thread_instance():
    """Every COUNT_SPECS bank is inside the bank's class and routes to the
    thread instance at K = 1, 5, 8 and 16 (the count instance's column
    sized with four more words a slot), but "count absent" at K = 16,
    whose column (6 capture words, enter, seq, deadline and four count
    instance words a slot) is past shared memory; K = 17 and nine
    constant compares go to the group instance too."""
    for name in COUNT_SPECS:
        for K in (1, 5, 8, 16):
            bank = _cbank(name, K)
            spec, kp = bank.nfa.spec, bank.nfa.kprog
            assert bank_class_reason(spec, kp) is None, name
            kinds = {u.kind for u in spec.units}
            assert "count" in kinds or any(kp.prog), name
            g = bank_geometry(K, T, len(kp.kern_attrs),
                              spec.n_rows * spec.n_caps,
                              sum(len(q) for q in kp.pcmp),
                              len(kp.param_names),
                              len(kernel_prog(spec, kp)),
                              count="count" in kinds,
                              absent="absent" in kinds, n_cond=len(kp.cmp))
            if name == "count absent" and K == 16:
                assert g.instance == "group" and g.TT == 0
                continue
            assert g.instance == "thread", (name, K)
            assert 0 < g.smem <= SMEM_LIMIT
    plain = bank_geometry(8, 64, 2, 4, 4, 4, 200)
    count = bank_geometry(8, 64, 2, 4, 4, 4, 200, count=True)
    assert plain.instance == count.instance == "thread"
    assert count.smem - plain.smem == 256 * 8 * 4 * 4
    for K, n_pcmp, RC in ((17, 4, 4), (8, 9, 4), (16, 4, 40)):
        g = bank_geometry(K, 64, 2, RC, n_pcmp, n_pcmp, 200, count=True)
        assert g.instance == "group" and g.TT == 0, (K, n_pcmp, RC)


@pytest.mark.parametrize("K", [1, 5, 8, 16])
@pytest.mark.parametrize("name", sorted(COUNT_SPECS))
def test_thread_model_counts_and_programs_equal_plain(name, K):
    """The thread instance's loop with count units and condition programs
    equals the plain bank step over three chained random blocks, every
    carry leaf (cnt_cur and cnt_prev too) and per-lane output, with CTAs
    of 32 patterns at K = 8 and of 4 else."""
    rng = np.random.default_rng(11 + K)
    bank = _cbank(name, K)
    _c, counts = _model_vs_plain(
        bank, [_block(rng, BASE + b * T * GAP) for b in range(3)],
        32 if K == 8 else 4)
    assert sum(int(c.sum()) for c in counts) > 0


@pytest.mark.parametrize("case", ["backwards", "padded", "wrap", "all_dead",
                                  "ragged"])
@pytest.mark.parametrize("name", ["config 4", "count bank", "ratio"])
def test_thread_model_counts_special_blocks(name, case):
    """The count and program banks on the blocks the dead-event walk must
    get right (ragged: T of 7 and 5 pad to B = 8 in the plain step, whose
    padding rows expire a slot that left config 4's leading count at the
    last event)."""
    rng = np.random.default_rng(SPECIAL.index(case))
    _c, counts = _model_vs_plain(_cbank(name, 8), _special_blocks(case, rng))
    if case == "all_dead":
        assert int(counts[1].sum()) == 0


#: (spec, K) held against the JAX bank: every K of the model tests once
JAX_COUNT_CASES = [("count bank", 8), ("config 4", 5),
                   ("mid-chain count", 16), ("count last read", 1),
                   ("ratio", 8)]


@pytest.mark.parametrize("name,K", JAX_COUNT_CASES)
def test_thread_model_counts_equal_jax_bank(name, K):
    """The JAX bank (build_bank_step as the JAX package runs it on the
    CPU) over the same blocks: per-pattern counts after every block and
    the final carry equal the thread model's (which equals the plain
    bank step's); the ratio bank at K = 8 drops partials."""
    text, vals = COUNT_SPECS[name]
    apps = [text.format(a=a, b=b) for a, b in vals]
    jb = JaxBank(apps, n_partitions=P, n_slots=K,
                 pattern_chunk=len(apps) // 2)
    blocks = [_block(np.random.default_rng(29), BASE + b * T * GAP)
              for b in range(3)]
    carry, counts = _model_vs_plain(_cbank(name, K), blocks)
    for b, raw in enumerate(blocks):
        jc = np.asarray(jb.process_block(raw))
        assert jc.tolist() == counts[b].sum(dim=1).tolist(), b
    for ci, jcar in enumerate(jb.carries):
        for k in jcar:
            x = np.asarray(jcar[k])
            y = carry[k][ci].numpy()
            assert x.dtype == y.dtype and np.array_equal(
                x.view(np.int32), y.view(np.int32)), (ci, k)
    assert sum(int(c.sum()) for c in counts) > 0
    if name == "ratio":
        assert int(carry["dropped"].sum()) > 0


SPECIALS = np.array([0.0, -0.0, 1.0, -1.0, 99.9, 1e-45, -1e-45, 1e-38,
                     3.4028235e38, -3.4028235e38, np.inf, -np.inf, np.nan],
                    np.float32)


@pytest.mark.parametrize("op", range(len(CMP_OPS)))
def test_pcmp_bounds_equal_compares(op):
    """``x op c`` == ``(lo <= x <= hi) != inv`` over IEEE special values
    (signed zeros, subnormals, the largest finites, infinities, NaN) and
    random floats, as constants and as event values."""
    rng = np.random.default_rng(op)
    vals = np.concatenate([SPECIALS, rng.normal(0, 50, 64).astype(
        np.float32)])
    with np.errstate(over="ignore"):
        vals = np.concatenate([vals, np.nextafter(vals, np.float32(np.inf)),
                               np.nextafter(vals, np.float32(-np.inf))])
    x = torch.from_numpy(vals)[:, None]
    c = torch.from_numpy(vals)
    lo, hi, inv = pcmp_bounds(op, c)
    want = [torch.lt, torch.le, torch.gt, torch.ge, torch.eq,
            torch.ne][op](x, c[None, :])
    got = ((x >= lo[None, :]) & (x <= hi[None, :])) != inv
    assert torch.equal(got, want), CMP_OPS[op]


@pytest.mark.parametrize("T_", [1, 4, 64, 4096])
@pytest.mark.parametrize("K", [1, 8, 16])
def test_bank_geometry_fits_shared_memory(K, T_, monkeypatch):
    """At the fleet's A = 2, R·C = 2 (4 constant compares) the thread
    instance runs at K = 1, 8 and 16 for every T, with a power-of-two
    tile of at least 4 events and at most 227 KB of shared memory, also
    sized for the other thread mapping (8 lanes a tile, the build
    tools/bank_probe.py times); a block that one tile holds is staged
    whole and walked by several pattern groups (the fleet shape: two
    CTAs an SM), a longer one tiled over T with one group a CTA."""
    from siddhi_tpu_torch.ops import nfa as ops
    bank = _kbank("alert", K)
    prog_len = len(kernel_prog(bank.nfa.spec, bank.nfa.kprog))
    for lanes in (32, 8):
        monkeypatch.setattr(ops, "BANK_LANES", lanes)
        g = bank_geometry(K, T_, 2, 2, 4, 4, prog_len)
        assert g.instance == "thread"
        assert g.TT >= 4 and g.TT & (g.TT - 1) == 0
        assert 0 < g.smem <= SMEM_LIMIT == 227 * 1024
        assert g.TT >= min(T_, 16)
        assert g.groups == (BANK_GROUPS if T_ <= g.TT else 1)
    monkeypatch.setattr(ops, "BANK_LANES", 32)
    fleet = bank_geometry(8, 64, 2, 2, 4, 4, prog_len)
    assert (fleet.TT, fleet.groups) == (64, BANK_GROUPS)
    assert fleet.smem <= SMEM_LIMIT // 2


@pytest.mark.parametrize("K,n_pcmp,RC", [(17, 4, 2), (32, 4, 2),
                                         (160, 4, 2), (8, 9, 2),
                                         (16, 4, 64)])
def test_bank_geometry_falls_to_group_instance(K, n_pcmp, RC):
    """More slots or compares than the thread instance's registers hold,
    or captures beyond its shared memory: the group instance."""
    g = bank_geometry(K, 64, 2, RC, n_pcmp, n_pcmp, 40)
    assert g.instance == "group" and g.TT == 0


def parse_prog(prog):
    """csrc/nfa_step.cu's ``parse`` of a program table, in Python: every
    field by the offsets the C code computes them from."""
    h = dict(zip(("S", "R", "C", "has_within", "within", "arm_once",
                  "n_cond", "n_cmp", "n_pcmp", "has_count", "has_absent",
                  "occ_hi"), prog[:PROG_HEADER]))
    S, R, C, n_cond = h["S"], h["R"], h["C"], h["n_cond"]
    pos = PROG_HEADER
    h["units"] = [tuple(prog[pos + UNIT_WORDS * j:pos + UNIT_WORDS * (j + 1)])
                  for j in range(S)]
    pos += UNIT_WORDS * S
    h["row_src"] = tuple(prog[pos:pos + R * C])
    pos += R * C
    rowx_start = prog[pos:pos + R + 1]
    pos += R + 1
    rowx = prog[pos:pos + rowx_start[R]]
    pos += rowx_start[R]
    h["rows"] = []
    for r in range(R):
        x = rowx[rowx_start[r]:rowx_start[r + 1]]
        if not x:
            h["rows"].append(None)
            continue
        nf, nl, nlane, ni, nm, L = x[:6]
        ib = tuple(tuple(x[6 + 3 * q:9 + 3 * q]) for q in range(ni))
        mb = tuple(x[6 + 3 * ni:6 + 3 * ni + nm])
        src = tuple(x[6 + 3 * ni + nm:6 + 3 * ni + nm + L])
        assert len(x) == 6 + 3 * ni + nm + L
        h["rows"].append((nf, nl, nlane, ib, mb, src))

    def table(width, n):
        nonlocal pos
        start = prog[pos:pos + n_cond + 1]
        pos += n_cond + 1
        flat = prog[pos:pos + width * n]
        pos += width * n
        return tuple(tuple(tuple(flat[width * q:width * q + width])
                           for q in range(start[i], start[i + 1]))
                     for i in range(n_cond))
    h["cmp"] = table(4, h["n_cmp"])
    h["pcmp"] = table(3, h["n_pcmp"])
    h.update(zip(WIDE_HEADER, prog[12:PROG_HEADER]))
    h["units_b"] = [tuple(prog[pos + WIDE_UNIT_WORDS * j:
                               pos + WIDE_UNIT_WORDS * (j + 1)])
                    for j in range(S)]
    pos += WIDE_UNIT_WORDS * S
    h["mid"] = [tuple(prog[pos + 2 * q:pos + 2 * q + 2])
                for q in range(h["n_mid"])]
    pos += 2 * h["n_mid"]
    h["ccmp"] = table(4, h["n_ccmp"])
    pstart = prog[pos:pos + n_cond + 1]
    pos += n_cond + 1
    words = prog[pos:pos + pstart[n_cond]]
    pos += pstart[n_cond]
    h["prog"] = tuple(tuple(words[pstart[i]:pstart[i + 1]])
                      for i in range(n_cond))
    n_k = 1 + max((w >> 8 for w in words if w & 0xff == 3), default=-1)
    h["pconst"] = tuple(prog[pos:pos + n_k])
    pos += n_k
    assert pos == len(prog)
    return h


def test_kernel_program_layout():
    """kernel_prog's table, parsed as csrc/nfa_step.cu parses it, gives
    back the units, both compare tables and the capture sources."""
    bank = _bank("chain3")
    spec, kp = bank.nfa.spec, bank.nfa.kprog
    h = parse_prog(kernel_prog(spec, kp))
    assert (h["S"], h["has_within"], h["within"], h["arm_once"]) == \
        (3, 1, 9000, 0)
    assert (h["has_count"], h["has_absent"], h["occ_hi"]) == (0, 0, -1)
    assert h["n_cond"] == len(spec.cond_fns) == len(kp.cmp) == len(kp.pcmp)
    assert [u[1:4] for u in h["units"]] == \
        [(u.stream_a, u.cond_a, u.row_a) for u in spec.units]
    # simple units land on the next unit; the last one completes
    assert [(u[0], u[7], u[8], u[9], u[10]) for u in h["units"]] == \
        [(0, 1, 0, -1, -1), (0, 2, 0, -1, -1), (0, 3, 0, -1, -1)]
    assert h["row_src"] == kp.row_src
    assert h["rows"] == [None] * h["R"]
    assert h["cmp"] == kp.cmp
    assert h["pcmp"] == kp.pcmp
    # e1: `{a} <= price` mirrored to `price >= {a}`, and `kind != 1`
    assert kp.pcmp[0] == ((kp.kern_attrs.index("price"), 0,
                           CMP_OPS.index(">=")),
                          (kp.kern_attrs.index("kind"), 1,
                           CMP_OPS.index("!=")))


def _ring_inputs(rng, CN, P_, K, counts):
    """Counts, lmt, lmk and a final carry for the ring, from numpy."""
    i32 = np.int32
    lmt = rng.integers(0, 1 << 20, (CN, P_)).astype(i32)
    carry = {"slot_state": torch.zeros((CN, P_, K), dtype=torch.int32),
             "slot_start": torch.from_numpy(
                 (lmt[:, :, None] + rng.integers(-4, 4, (CN, P_, K)))
                 .astype(i32)),
             "captures": torch.from_numpy(rng.standard_normal(
                 (CN, P_, K, 2, 1)).astype(np.float32))}
    return (carry, torch.from_numpy(np.asarray(counts).astype(i32)),
            torch.from_numpy(lmt),
            torch.from_numpy(rng.integers(0, K, (CN, P_)).astype(i32)))


#: {case: (P, ring, tile or None for ring_geometry's, counts over (rng, P))}
RING_CASES = {
    "few_values": (300, 32, None, lambda r, n: r.integers(0, 3, n)),
    "all_equal": (300, 32, None, lambda r, n: np.full(n, 5)),
    "all_zero": (300, 32, None, lambda r, n: np.zeros(n, np.int64)),
    "ring_is_P": (300, 300, None, lambda r, n: r.integers(0, 3, n)),
    "ring_1": (300, 1, None, lambda r, n: r.integers(0, 3, n)),
    "sparse": (300, 32, None, lambda r, n: (r.random(n) < 0.02) *
               r.integers(1, 4, n)),
    "wide_P": (10_000, 32, None, lambda r, n: r.integers(0, 2, n)),
    "P_not_multiple_of_32": (1001, 32, None,
                             lambda r, n: r.integers(0, 40, n)),
    "to_512_ties_straddle_v": (2000, 32, None,
                               lambda r, n: r.integers(0, 513, n)),
    "tiled_smem": (60_000, 32, None, lambda r, n: r.integers(0, 513, n)),
    "small_tiles": (1000, 32, 128, lambda r, n: r.integers(0, 9, n)),
    "small_tiles_ring_above_tile": (1000, 300, 128,
                                    lambda r, n: r.integers(0, 40, n)),
    "ring_0": (300, 0, None, lambda r, n: r.integers(0, 513, n)),
    "ring_is_P_tiled": (1000, 1000, 256, lambda r, n: r.integers(0, 5, n)),
    "int32_extremes": (1000, 32, 128, lambda r, n: r.choice(
        np.array([-2**31, -7, 0, 1, 2**31 - 1]), n)),
    "wide_range_20_steps": (1000, 32, None,
                          lambda r, n: r.integers(0, 1_000_000, n)),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_selection_model_equals_stable_sort(case):
    """ops/nfa.bank_ring_model, the ring kernel's CPU model (tiles, the
    bisection with per-warp counts, ballot compaction in 128-lane
    segments, the merge of the tiles' lists), selects the lanes of the
    stable descending sort, and totals the row modulo 2^32."""
    P_, ring, tile, counts = RING_CASES[case]
    rng = np.random.default_rng(list(RING_CASES).index(case))
    if tile is None and case == "tiled_smem":
        assert ring_geometry(P_, ring).tile < P_
    count = counts(rng, P_).astype(np.int64)
    carry, cnt, lmt, lmk = _ring_inputs(rng, 1, P_, 2, count[None])
    out = bank_ring_model(carry, cnt, lmt, lmk, ring, tile)
    assert out[0].tolist() == [int(np.int64(count.sum()).astype(np.int32))]
    if not ring:
        assert len(out) == 1
        return
    want = torch.sort(cnt[0], descending=True, stable=True).indices[:ring]
    assert torch.equal(out[2][0].long(), want)
    assert torch.equal(out[1][0], cnt[0][want])


def _jax_ring(carry, count, lmt, lmk, ring):
    """siddhi_tpu/ops/nfa.py's ring (``pattern_step``'s lines after the
    lane step: ``jnp.sum`` and ``jax.lax.top_k`` and the payload gathers),
    per pattern under ``jax.vmap``, on numpy inputs."""
    def one(c, counts, lmt, lmk):
        total = jnp.sum(counts)
        if not ring:
            return (total,)
        ring_cnt, ring_pid = jax.lax.top_k(counts, ring)
        sel_k = lmk[ring_pid]
        ring_caps = c["captures"][ring_pid, sel_k]
        ring_ts = lmt[ring_pid]
        ring_ok = c["slot_start"][ring_pid, sel_k] <= ring_ts
        return total, ring_cnt, ring_pid, ring_caps, ring_ts, ring_ok
    c = {k: jnp.asarray(carry[k].numpy())
         for k in ("captures", "slot_start")}
    return tuple(np.asarray(x) for x in jax.vmap(one)(
        c, jnp.asarray(count.numpy()), jnp.asarray(lmt.numpy()),
        jnp.asarray(lmk.numpy())))


@pytest.mark.parametrize("case", ["sparse", "to_512_ties_straddle_v",
                                  "small_tiles", "ring_is_P_tiled", "ring_0",
                                  "tiled_smem", "wide_range_20_steps"])
def test_ring_model_plain_and_jax_top_k_agree(case):
    """The CPU model, bank_ring_plain and the JAX package's lax.top_k ring
    on the same numpy-seeded counts and carry (3 patterns, K = 4): all six
    outputs equal bit for bit."""
    P_, ring, tile, counts = RING_CASES[case]
    rng = np.random.default_rng(100 + list(RING_CASES).index(case))
    CN = 1 if P_ > 10_000 else 3
    carry, cnt, lmt, lmk = _ring_inputs(
        rng, CN, P_, 4, np.stack([counts(rng, P_) for _ in range(CN)]))
    model = bank_ring_model(carry, cnt, lmt, lmk, ring, tile)
    plain = bank_ring_plain(carry, cnt, lmt, lmk, ring)
    ref = _jax_ring(carry, cnt, lmt, lmk, ring)
    assert len(model) == len(plain) == len(ref) == (6 if ring else 1)
    for m, p_, j in zip(model, plain, ref):
        assert m.dtype == p_.dtype and torch.equal(m, p_)
        mj = m.numpy()
        assert mj.shape == j.shape and mj.view(np.uint8).tobytes() == \
            j.astype(mj.dtype).view(np.uint8).tobytes()


@pytest.mark.parametrize("P_,ring", [(10_000, 32), (9_999, 32),
                                     (10_000, 10_000), (58_000, 32),
                                     (60_000, 32), (150_001, 1000),
                                     (1, 1), (300, 0)])
def test_ring_geometry_fits_shared_memory(P_, ring):
    """One tile (the whole row) wherever the layout fits the CTA's 227 KB;
    else tiles of a multiple of 128 lanes that hold the merged list; the
    size is the layout's, under the limit.  The fleet's row is one tile
    of 40 KB: five CTAs fit an SM."""
    geo = ring_geometry(P_, ring)
    assert geo.smem == 4 * ring_layout_ints(P_, ring, geo.tile) <= SMEM_LIMIT
    if 4 * ring_layout_ints(P_, ring, P_) <= SMEM_LIMIT:
        assert geo.tile == P_
    else:
        assert geo.tile < P_ and geo.tile % 128 == 0
        assert geo.tile >= 2 * ring
    if (P_, ring) == (10_000, 32):
        assert geo.smem == 40_448 and 5 * (geo.smem + 1024) <= 228 * 1024


def test_ring_geometry_refuses_a_ring_without_a_tile():
    assert ring_geometry(14_000, 14_000).tile == 14_000
    with pytest.raises(ValueError, match="leaves no tile"):
        ring_geometry(20_000, 20_000)


def test_ring_plain_zero_rows_and_payload():
    """Fewer matched lanes than the ring: zero-count lanes fill it in lane
    order with lmk = lmt = 0, captures of slot 0 and ok = start <= 0."""
    CN, P_, K = 2, 6, 3
    carry = {"slot_state": torch.full((CN, P_, K), -1, dtype=torch.int32),
             "slot_start": torch.arange(CN * P_ * K, dtype=torch.int32)
             .reshape(CN, P_, K) - 4,
             "captures": torch.arange(CN * P_ * K * 2, dtype=torch.float32)
             .reshape(CN, P_, K, 2, 1)}
    count = torch.tensor([[0, 2, 0, 1, 0, 0], [0] * 6], dtype=torch.int32)
    lmt = torch.tensor([[0, 9, 0, 3, 0, 0], [0] * 6], dtype=torch.int32)
    lmk = torch.tensor([[0, 2, 0, 1, 0, 0], [0] * 6], dtype=torch.int32)
    total, rcnt, rpid, rcaps, rts, rok = bank_ring_plain(carry, count, lmt,
                                                         lmk, 4)
    assert total.tolist() == [3, 0]
    assert rpid.tolist() == [[1, 3, 0, 2], [0, 1, 2, 3]]
    assert rcnt.tolist() == [[2, 1, 0, 0], [0, 0, 0, 0]]
    assert rts.tolist() == [[9, 3, 0, 0], [0, 0, 0, 0]]
    # slot_start[n, p, k] = (n * P + p) * K + k - 4 against ts: lane 3's
    # slot 1 (start 6) and lane 2's slot 0 (start 2) were re-armed after
    assert rok.tolist() == [[True, False, True, False],
                            [False, False, False, False]]
    assert rcaps[0, 0, :, 0].tolist() == [10.0, 11.0]    # lane 1, slot 2


def test_bank_step_cpu_is_plain():
    """nfa_bank_step on CPU tensors is the plain composition, ring
    outputs included, and leaves its input carry alone."""
    bank = _bank("alert")
    block = bank.nfa.to_device(_block(np.random.default_rng(3), BASE))
    carry = {k: v.clone() for k, v in bank._stack_carry.items()}
    new, res = nfa_bank_step(bank.nfa.spec, carry, block,
                             bank._stack_params, 8, bank.nfa.kprog)
    new_p, res_p = nfa_bank_step_plain(bank.nfa.spec, carry, block,
                                       bank._stack_params, 8)
    for k in carry:
        assert torch.equal(carry[k], bank._stack_carry[k])
        assert torch.equal(new[k], new_p[k])
    for x, y in zip(res, res_p):
        assert torch.equal(x, y)
    assert int(res[0].sum()) > 0


#: banks outside the bank kernels' class, which is the single-pattern
#: step's (a transcendental; every structural kind of the step runs the
#: bank's widened instance, tests/test_torch_bank_widened.py)
OUT_OF_CLASS = {
    # a kleene count whose own condition reads its [last] bank through a
    # transcendental; counts otherwise run on the thread instance
    "count unit": (STREAM + "from every e1=S[kind == 0 and price > {t} and "
                   "math:log(price) < e1[last].price]<2:3> -> e2=S[kind == "
                   "1 and price > e1[last].price] select e2.price as p2 "
                   "insert into Out;", "transcendental"),
    "arithmetic on a constant": (
        STREAM + "from every e1=S[kind == 0 and math:exp(price) > {t}] -> "
        "e2=S[kind == 1 and price > e1.price] select e1.price as p1 "
        "insert into Out;", "transcendental math:exp"),
}


@pytest.mark.parametrize("name", sorted(OUT_OF_CLASS))
def test_out_of_class_bank_refused_on_cuda(name, monkeypatch):
    """A bank outside the step's class (a transcendental: what K2 refuses,
    the only refusals the bank has) on CUDA: torch.cuda reported
    available, the refusal comes before any device memory is touched
    (this torch has no CUDA, so an allocation would fail otherwise); the
    CPU bank runs the same apps."""
    text, word = OUT_OF_CLASS[name]
    apps = [text.format(t=t) for t in (10.0, 60.0)]
    cpu = CompiledPatternBank(apps, n_partitions=4, n_slots=2,
                              device="cpu")
    assert word in cpu.nfa.kprog.reason
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SiddhiAppCreationError, match=word):
        CompiledPatternBank(apps, n_partitions=4, n_slots=2, device="cuda")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    text, vals = SPECS["alert"]
    with pytest.raises(RuntimeError, match="cuda"):
        CompiledPatternBank([text.format(a=a, b=b) for a, b in vals],
                            n_partitions=4)


def test_bank_import_leaves_jax_out():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys, siddhi_tpu_torch\n"
            "from siddhi_tpu_torch.plan.nfa_compiler import "
            "CompiledPatternBank\n"
            "from siddhi_tpu_torch.ops.nfa import nfa_bank_step\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'siddhi_tpu' not in sys.modules, 'siddhi_tpu imported'\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
