"""The pattern bank on the single-pattern step's whole class, held on the
CPU against the JAX package.

The bank step's widened instances cannot run here: the thread instance
(csrc/nfa_bank_wide.cu ``nfa_bank_thread_wide``, one thread per
(pattern, lane)) and the group instance (csrc/nfa_wide.cu
``nfa_bank_step_wide``: K > 16, more than 8 constant compares, a column
past shared memory).  What they compute is held by their CPU models:
the plain bank step driven through the kernel program
(``bank_lanes_plain(..., kprog=)``: the gate word, the pattern constants'
compares, the capture compares, the programs) for the group instance,
and ``bank_thread_model`` (the thread instance's CTAs of patterns,
candidates and dead-event rule: a dead event is the plain step with the
row's gate word zero) for the thread instance, bit for bit:

- for each bank kind the bank kernels refused before they took the
  widened class — logical ``and`` and ``or``, SEQUENCE, an ``every``
  group, mid-chain and trailing ``every``, a leading min-0 count, a
  leading absence, telemetry, a capture compare and a program in the
  first condition (chip_smoke.WIDE_BANK_APPS) — and for a ``<capture>
  <cmp> <constant>`` compare (in a bank a program against the pattern's
  constant, on the thread instance), over three chained blocks of T = 7
  (ragged at B = 4) at B = 1 and 4, stacked (two chunks
  of two patterns), the JAX package's bank, the port's plain bank step
  and the kernel model agree on every carry leaf (lmask, seq_froze and
  telem included), the per-pattern counts and the ring; the plain bank
  and the models also on each lane's count, last-match ts and slot;
- the thread instance's model against the plain bank step for every
  kind at K = 8 (alert band, blocks of T = 1, 4 and a tiled 130) and
  K = 16 (matchy band, T = 4 and 7, ragged at B = 4), in CTAs of two
  patterns; and on all-dead blocks after live ones, where a zero gate
  word still changes the lane: a SEQUENCE partial killed by every real
  event, telemetry fails counted on every event, a leading absent unit
  and a leading min-0 count armed on dead events;
- the padding rows' `within` pass: a leading count bank at K = 24 (the
  group instance) on a ragged block where the plain step's padding rows
  expire partials, model == plain == JAX;
- the widened leaves through grow-and-replay: a replayable bank from
  K = 1 ends equal, counts and carry, to one built at its final K;
- ``bank_class_reason`` is None exactly where ``kprog.reason`` and
  ``kernel_class_reason`` are; ``bank_geometry`` picks the widened
  thread instance for the widened kinds within its limits and the
  widened group instance at K = 24, at nine constant compares and past
  shared memory, and leaves the cases of test_torch_bank_kernel.py on
  the instance they ran before; the transcendental banks stay refused
  on CUDA.
"""
import os
import sys
import warnings

import jax  # noqa: F401  (the JAX bank below runs on the CPU)
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from siddhi_tpu.plan.nfa_compiler import \
    CompiledPatternBank as JaxBank  # noqa: E402
from siddhi_tpu_torch.ops.nfa import (SMEM_LIMIT,  # noqa: E402
                                      bank_class_reason, bank_geometry,
                                      bank_lanes_plain, bank_ring_plain,
                                      bank_thread_model, bank_wide_words,
                                      kernel_class_reason, kernel_prog,
                                      kernel_wide)
from siddhi_tpu_torch.ops.pack import pack_blocks  # noqa: E402
from siddhi_tpu_torch.plan.nfa_compiler import \
    CompiledPatternBank  # noqa: E402

from test_torch_bank_kernel import (COUNT_SPECS, OUT_OF_CLASS,  # noqa: E402
                                    SPECS)

P, K, N, RING, BASE, GAP = 16, 4, 4, 8, 1_000_000, 1_000
#: the chained blocks' T: ragged at B = 4 (one T: one JAX compile a bank)
TS = (7, 7, 7)
THRS = np.linspace(10.0, 80.0, N)
RING_NAMES = ("counts", "ring_cnt", "ring_pid", "ring_caps", "ring_ts",
              "ring_ok")


def _raw(rng, t0, T, p_kind0=1 / 3):
    """A [P, T] block: lane p's event j at t0 + j * GAP + p * (GAP // P),
    price U[0, 100), kind 0 with probability p_kind0, else 1 or 2."""
    n = P * T
    pids = np.tile(np.arange(P, dtype=np.int64), T)
    j = np.repeat(np.arange(T, dtype=np.int64), P)
    ts = t0 + j * GAP + pids * (GAP // P)
    kind = np.where(rng.random(n) < p_kind0, 0, rng.integers(1, 3, n))
    cols = {"partition": pids.astype(np.float32),
            "price": rng.uniform(0, 100, n).astype(np.float32),
            "kind": kind.astype(np.float32)}
    return pack_blocks(pids, cols, ts, np.zeros(n, np.int32), P,
                       base_ts=BASE)


def _apps(name):
    text, tel = cs.WIDE_BANK_APPS[name]
    return [cs._S3 + text.format(t=round(float(t), 3)) for t in THRS], tel


def _same(what, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.itemsize == 4:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), what


def _run(apps, tel, B, k=K, blocks=None, seed=11, p_kind0=1 / 3):
    """The JAX bank, the plain bank and the kernel models (the group
    instance's, the thread instance's in CTAs of two patterns) over
    chained blocks, equal after each; → (the plain's final carry,
    per-block counts, the plain bank)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = CompiledPatternBank(apps, n_partitions=P, n_slots=k,
                                   pattern_chunk=N // 2, ring=RING,
                                   batch_b=B, telemetry=tel, device="cpu")
        jb = JaxBank(apps, n_partitions=P, n_slots=k, pattern_chunk=N // 2,
                     ring=RING, batch_b=B, telemetry=tel)
    assert port.stacked and jb.stacked
    spec, kp, prm = port.nfa.spec, port.nfa.kprog, port._stack_params
    assert kp.reason is None, kp.reason
    rng = np.random.default_rng(seed)
    c_plain = c_model = c_thread = port._stack_carry
    t0, counts = BASE, []
    for bi, T in enumerate(TS if blocks is None else blocks):
        raw = _raw(rng, t0, T, p_kind0)
        t0 += T * GAP
        blk = port.nfa.to_device(raw)
        lanes_p = bank_lanes_plain(spec, c_plain, blk, prm, B)
        lanes_m = bank_lanes_plain(spec, c_model, blk, prm, B, kprog=kp)
        lanes_t = bank_thread_model(spec, c_thread, blk, prm, kp,
                                    cta_patterns=2, batch_b=B)
        _same_lanes(f"block {bi} thread model", lanes_t, lanes_p)
        res_p = bank_ring_plain(*lanes_p, RING)
        res_m = bank_ring_plain(*lanes_m, RING)
        jres = jb.process_block(raw)
        assert sorted(lanes_p[0]) == sorted(lanes_m[0]) == \
            sorted(jb.carries[0])
        for k_ in lanes_p[0]:
            _same(f"block {bi} model carry.{k_}", lanes_m[0][k_],
                  lanes_p[0][k_])
            for ci, jc in enumerate(jb.carries):
                _same(f"block {bi} JAX carry.{k_} chunk {ci}", jc[k_],
                      lanes_p[0][k_][ci])
        for i, n_ in enumerate(("count", "lmt", "lmk"), 1):
            _same(f"block {bi} model {n_}", lanes_m[i], lanes_p[i])
        for n_, x, y, z in zip(RING_NAMES, res_p, res_m, jres):
            _same(f"block {bi} model {n_}", y, x)
            _same(f"block {bi} JAX {n_}", z, x)
        c_plain, c_model, c_thread = lanes_p[0], lanes_m[0], lanes_t[0]
        counts.append(res_p[0])
    return c_plain, counts, port


def _same_lanes(what, got, want):
    """(carry, count, lmt, lmk) of a model against the plain bank's."""
    assert sorted(got[0]) == sorted(want[0])
    for k_ in want[0]:
        _same(f"{what} carry.{k_}", got[0][k_], want[0][k_])
    for i, n_ in enumerate(("count", "lmt", "lmk"), 1):
        _same(f"{what} {n_}", got[i], want[i])


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("name", sorted(cs.WIDE_BANK_APPS))
def test_widened_bank_equals_jax_and_kernel_model(name, B):
    """JAX bank == plain bank == kernel model over chained blocks, ragged
    at B = 4: every carry leaf, counts, lmt, lmk and ring."""
    apps, tel = _apps(name)
    carry, counts, _bank = _run(apps, tel, B)
    if name == "first capture":
        # a leading count's own [last] is null on an empty chain, so the
        # JAX step never arms it: the state stays empty
        assert int((carry["slot_state"] >= 0).sum()) == 0
        return
    assert sum(int(c.sum()) for c in counts) > 0, name
    if tel:
        assert int(carry["telem"].sum()) > 0


def test_padding_rows_within_pass_on_the_group_instance():
    """A leading count bank at K = 24 (the group instance): on the ragged
    block the plain step's padding rows expire partials that left the
    count at the last event; the kernel model runs that pass too."""
    apps = [cs._S3 + f"from every e1=S[kind == 0 and price > {t}]<3:5> -> "
            "e2=S[kind == 1 and price > e1[last].price] within 3 sec "
            "select e1[0].price as p0, e2.price as p2 insert into Out;"
            for t in THRS]
    # seed 3: the padding rows expire two partials
    carry4, _c, bank = _run(apps, False, 4, k=24, blocks=(7, 7), seed=3,
                            p_kind0=0.7)
    spec, kp, prm = bank.nfa.spec, bank.nfa.kprog, bank._stack_params
    assert not kernel_wide(spec, kp)
    assert bank_geometry(24, 7, len(kp.kern_attrs), 1, 0, 0, 1,
                         count=True).instance == "group"
    # the same blocks at B = 1 (no padding rows), from the bank's empty
    # carry (the steps above are functional)
    rng = np.random.default_rng(3)
    carry1 = bank._stack_carry
    for i in range(2):
        blk = bank.nfa.to_device(_raw(rng, BASE + i * 7 * GAP, 7, 0.7))
        carry1 = bank_lanes_plain(spec, carry1, blk, prm, 1)[0]
    expired = int((carry1["slot_state"] != carry4["slot_state"]).sum())
    assert expired > 0 and bool(
        (carry4["slot_state"][carry1["slot_state"] != carry4["slot_state"]]
         == -1).all())


@pytest.mark.parametrize("name", sorted(cs.WIDE_BANK_APPS))
def test_widened_banks_are_in_class_on_the_widened_instance(name):
    """bank_class_reason is None; the widened kinds run the widened
    thread instance within its limits (K <= 16, at most 8 constant
    compares, the layout within shared memory), else the widened group
    instance (K = 24,
    nine compares, a column past shared memory); the capture-to-constant
    compare (a program in a bank) runs the thread instance."""
    apps, tel = _apps(name)
    bank = CompiledPatternBank(apps, n_partitions=P, n_slots=K,
                               pattern_chunk=N // 2, telemetry=tel,
                               device="cpu")
    spec, kp = bank.nfa.spec, bank.nfa.kprog
    assert bank_class_reason(spec, kp) is None
    wide = kernel_wide(spec, kp)
    assert wide == (name != "capture constant")
    RC = max(spec.n_rows, 1) * max(spec.n_caps, 1)
    prog_len = len(kernel_prog(spec, kp))

    def geo(k, n_pcmp=sum(len(q) for q in kp.pcmp), words=None):
        return bank_geometry(
            k, 64, len(kp.kern_attrs), RC, n_pcmp, len(kp.param_names),
            prog_len, count=any(u.kind == "count" for u in spec.units),
            absent=any(u.kind == "absent" for u in spec.units),
            n_cond=len(kp.cmp), wide=wide,
            wide_words=(bank_wide_words(spec, k, RC) if words is None
                        else words) if wide else 0,
            n_units=len(spec.units))
    g8 = geo(8)
    assert geo(K).instance == g8.instance == \
        ("wide_thread" if wide else "thread")
    assert 0 < g8.smem <= SMEM_LIMIT
    assert geo(24).instance == ("wide" if wide else "group")
    assert geo(8, n_pcmp=9).instance == ("wide" if wide else "group")
    if wide:
        assert geo(8, words=SMEM_LIMIT // 4 // 256).instance == "wide"
        with pytest.raises(ValueError):
            bank_geometry(8, 64, 2, RC, 1, 1, prog_len, wide=True)


#: the thread model's shapes: (K, thresholds, the chained blocks' T, B)
THREAD_SHAPES = {
    "K8 alert T1-4-130": (8, np.linspace(99.8, 99.997, N), (1, 4, 130), 4),
    "K16 matchy T4-7": (16, np.linspace(5.0, 95.0, N), (4, 7), 4)}


def _thread_bank(name, k, thrs, B):
    text, tel = cs.WIDE_BANK_APPS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return CompiledPatternBank(
            [cs._S3 + text.format(t=round(float(t), 3)) for t in thrs],
            n_partitions=P, n_slots=k, pattern_chunk=N // 2, ring=RING,
            batch_b=B, telemetry=tel, device="cpu")


def _thread_vs_plain(bank, raws, B):
    """The thread instance's model (CTAs of two patterns) against the
    plain bank step over chained raw blocks, equal after each; → the
    carries after each block (the input first) and the total matches."""
    spec, kp, prm = bank.nfa.spec, bank.nfa.kprog, bank._stack_params
    carries, total = [bank._stack_carry], 0
    for bi, raw in enumerate(raws):
        blk = bank.nfa.to_device(raw)
        want = bank_lanes_plain(spec, carries[-1], blk, prm, B)
        got = bank_thread_model(spec, carries[-1], blk, prm, kp,
                                cta_patterns=2, batch_b=B)
        _same_lanes(f"block {bi}", got, want)
        carries.append(want[0])
        total += int(want[1].sum())
    return carries, total


@pytest.mark.parametrize("shape", sorted(THREAD_SHAPES))
@pytest.mark.parametrize("name", sorted(cs.WIDE_BANK_APPS))
def test_widened_thread_model_equals_plain(name, shape):
    """The widened thread instance's model equals the plain bank step,
    every carry leaf and each lane's count, last-match ts and slot, at
    K = 8 on the alert band (T = 1, 4 and a T = 130 block the kernel
    tiles, ragged at B = 4) and at K = 16 on the matchy band."""
    k, thrs, ts, B = THREAD_SHAPES[shape]
    bank = _thread_bank(name, k, thrs, B)
    rng = np.random.default_rng(17)
    raws, t0 = [], BASE
    for T_ in ts:
        raws.append(_raw(rng, t0, T_))
        t0 += T_ * GAP
    _carries, total = _thread_vs_plain(bank, raws, B)
    if shape.startswith("K16") and name != "first capture":
        assert total > 0


def _dead_raw(t0, T_):
    """A [P, T] block whose events pass no condition's gate (kind 5),
    valid, on stream 0."""
    n = P * T_
    pids = np.tile(np.arange(P, dtype=np.int64), T_)
    j = np.repeat(np.arange(T_, dtype=np.int64), P)
    cols = {"partition": pids.astype(np.float32),
            "price": np.full(n, 50.0, np.float32),
            "kind": np.full(n, 5.0, np.float32)}
    return pack_blocks(pids, cols, t0 + j * GAP + pids * (GAP // P),
                       np.zeros(n, np.int32), P, base_ts=BASE)


@pytest.mark.parametrize("name", ["sequence", "telemetry", "leading absent",
                                  "leading min-0"])
def test_widened_thread_model_dead_events(name):
    """A live block, then a block of dead events (no condition's gate
    bit), where the zero gate word still changes the lane: every real
    event kills a SEQUENCE partial; every event counts a telemetry fail
    for each slot waiting at a unit on its stream; a leading absent unit
    and a leading min-0 count arm on dead events.  The thread model
    equals the plain bank step."""
    bank = _thread_bank(name, 8, np.linspace(5.0, 60.0, N), 4)
    rng = np.random.default_rng(23)
    (c0, c1, c2), _total = _thread_vs_plain(
        bank, [_raw(rng, BASE, 7), _dead_raw(BASE + 7 * GAP, 6)], 4)
    if name == "sequence":
        assert int((c1["slot_state"] >= 0).sum()) > 0
        assert int((c2["slot_state"] >= 0).sum()) == 0
    elif name == "telemetry":
        S = len(bank.nfa.spec.units)
        fails = c2["telem"][..., 2 * S:3 * S] - c1["telem"][..., 2 * S:3 * S]
        assert int(fails.sum()) > 0
    else:
        # from an empty carry, the dead block alone arms the lanes
        _cs, _t = _thread_vs_plain(bank, [_dead_raw(BASE, 6)], 4)
        assert int((_cs[0]["slot_state"] >= 0).sum()) == 0
        assert int((_cs[1]["slot_state"] >= 0).sum()) > 0


def _bank_of(text, vals, k, fmt):
    return CompiledPatternBank([text.format(**fmt(v)) for v in vals],
                               n_partitions=P, n_slots=k,
                               pattern_chunk=len(vals) // 2, device="cpu")


@pytest.mark.parametrize("k", [4, 8, 17])
def test_present_bank_cases_keep_their_instance(k):
    """Every bank of test_torch_bank_kernel.py is no widened program: the
    thread or group instance it ran on before (K = 17: the group)."""
    banks = [_bank_of(t, v, k, lambda x: dict(a=x[0], b=x[1]))
             for t, v in SPECS.values()]
    banks += [_bank_of(t, v, k, lambda x: dict(a=x[0], b=x[1]))
              for t, v in COUNT_SPECS.values()]
    for bank in banks:
        spec, kp = bank.nfa.spec, bank.nfa.kprog
        assert bank_class_reason(spec, kp) is None
        assert not kernel_wide(spec, kp)
        args = (k, 64, len(kp.kern_attrs), 2, sum(len(q) for q in kp.pcmp),
                len(kp.param_names), 200)
        kw = dict(count=any(u.kind == "count" for u in spec.units),
                  absent=any(u.kind == "absent" for u in spec.units),
                  n_cond=len(kp.cmp))
        geo = bank_geometry(*args, **kw)
        assert geo.instance != "wide"
        assert bank_geometry(*args, **kw, wide=False) == geo
        if k > 16:
            assert geo.instance == "group"


@pytest.mark.parametrize("name", sorted(OUT_OF_CLASS))
def test_bank_class_is_the_step_class(name, monkeypatch):
    """bank_class_reason is the kernel program's reason or the structural
    limit, nothing else: the transcendental banks keep theirs, and stay
    refused on CUDA when the bank is built."""
    text, word = OUT_OF_CLASS[name]
    apps = [text.format(t=t) for t in (10.0, 60.0)]
    bank = CompiledPatternBank(apps, n_partitions=4, n_slots=2,
                               device="cpu")
    spec, kp = bank.nfa.spec, bank.nfa.kprog
    reason = bank_class_reason(spec, kp)
    assert reason == (kp.reason or kernel_class_reason(spec))
    assert reason is not None and word in reason
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(Exception, match=word):
        CompiledPatternBank(apps, n_partitions=4, n_slots=2, device="cuda")


@pytest.mark.parametrize("name", ["logical and", "mid every", "telemetry"])
def test_widened_bank_grows_and_replays(name):
    """The widened leaves (lmask, telem) through grow-and-replay: a
    replayable bank from K = 1 (process_block_replayed widens every slot
    leaf, lmask included, and replays) ends with the counts and carry of
    a bank built at its final K, slot for slot."""
    apps, tel = _apps(name)
    kw = dict(n_partitions=P, pattern_chunk=N // 2, telemetry=tel,
              device="cpu")
    grown = CompiledPatternBank(apps, n_slots=1, replayable=True, **kw)
    rng = np.random.default_rng(5)
    raws = [_raw(rng, BASE + i * 7 * GAP, 7) for i in range(3)]
    got = [grown.process_block_replayed(r) for r in raws]
    k = grown.nfa.spec.n_slots
    assert k > 1 and grown.total_dropped() == 0
    fresh = CompiledPatternBank(apps, n_slots=k, **kw)
    want = [fresh.process_block(r) for r in raws]
    for g_, w_ in zip(got, want):
        _same("counts", g_, w_)
    for leaf, v in fresh._stack_carry.items():
        _same(f"carry.{leaf}", grown._stack_carry[leaf], v)
