"""The widened kernel class — kleene counts ``<m:n>`` and absent units
``not … for t`` — held on the CPU against the JAX package.

csrc/nfa_step.cu's step (K2), its compaction (K4) and the bank step's
instances (K3) cannot run here (no card, no nvcc).  What they compute is
held by their CPU models, bit for bit:

- for every widened shape (counts anywhere but a leading min-0 one, with
  e[0], e[k], e[last], e[last-j] and the __n lane, min == max, max
  COUNT_INF, trailing, a min-0 count after a unit; absent units mid-chain,
  trailing, chained, with `within`) and over chained blocks with TIMER
  blocks (T = 1) between them, the JAX package's ``build_block_step``, the
  port's plain step and the kernel model (the plain step driven through
  the kernel program: gate word and compare tables) agree on every carry
  leaf and every output;
- the plain compaction's tail (count, dropped, earliest live absent
  deadline) equals the JAX ``pack``;
- the bank thread instance's model with absent units equals the plain
  bank step and the JAX bank;
- the program table's new fields (each unit's kind, count bounds, wait,
  landing and appending counts; each count row's layout) are what the C
  ``parse`` reads;
- ``bank_geometry`` routes a count bank and an absent bank to the
  thread instance, with their count and deadline columns, and a count
  bank of K = 17 to the group instance;
- ``chip_smoke.py``'s independent references of phases 10 (BASELINE
  config 4) and 11 (config 3) equal the JAX host engine on small streams.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from siddhi_tpu import SiddhiManager as JaxManager  # noqa: E402
from siddhi_tpu import StreamCallback as JaxCallback  # noqa: E402
from siddhi_tpu.ops.nfa import build_block_step  # noqa: E402
from siddhi_tpu.ops.nfa import \
    make_timer_block as jax_timer_block  # noqa: E402
from siddhi_tpu.plan.nfa_compiler import \
    CompiledPatternBank as JaxBank  # noqa: E402
from siddhi_tpu.plan.nfa_compiler import \
    CompiledPatternNFA as JaxNFA  # noqa: E402
from siddhi_tpu_torch.ops.nfa import (COUNT_INF, UNIT_KINDS,  # noqa: E402
                                      _land_static, _structural_wide,
                                      bank_class_reason, kernel_wide,
                                      bank_geometry,
                                      bank_lanes_plain, bank_thread_model,
                                      kernel_class_reason, kernel_prog,
                                      nfa_block_step_plain, nfa_step_egress)
from siddhi_tpu_torch.plan.nfa_compiler import (  # noqa: E402
    CompiledPatternBank, CompiledPatternNFA)

import chip_smoke  # noqa: E402
from test_torch_bank_kernel import parse_prog  # noqa: E402
from test_torch_nfa_step import (OUT_NAMES, _blocks, _same,  # noqa: E402
                                 _torch_block, _torch_carry)

STREAM = "define stream S (price float, kind int);\n"

#: widened shapes: {name: query} over STREAM (kinds 0..2, prices in
#: [0, 100), blocks of _blocks' feed: 220 events over three lanes)
WIDENED = {
    "count mid-chain":
        "from every e1=S[kind == 0] -> e2=S[kind == 1 and price > "
        "e1.price]<1:3> -> e3=S[kind == 2 and price < e2[last].price] "
        "within 20 sec select e1.price as p1, e2[0].price as f2, "
        "e2[last].price as l2, e3.price as p3 insert into Out;",
    "count leading (config 4)":
        "from every e1=S[kind == 0]<3:10> -> e2=S[kind == 1 and price > "
        "e1[last].price] within 60 sec select e1[0].price as p0, "
        "e1[last].price as pl, e2.price as p2 insert into Out;",
    "count leading, min 1":
        "from e1=S[kind == 0]<1:4> -> e2=S[kind == 1 and price > "
        "e1[last].price] select e1[0].price as p0, e1[last].price as pl, "
        "e2.price as p2 insert into Out;",
    "count leading, max 1":
        "from every e1=S[kind == 0 and price > 40.0]<1:1> -> e2=S[kind == 1 "
        "and price > e1[last].price] select e1.price as p1, e2.price as p2 "
        "insert into Out;",
    "count banks":
        "from every e1=S[kind == 0] -> e2=S[kind == 1]<2:5> -> e3=S[kind == "
        "2 and price > e2[last].price] within 30 sec select e2[0].price as "
        "f, e2[1].price as i1, e2[3].price as i3, e2[last].price as l, "
        "e2[last-1].price as m1, e2[last-2].price as m2, e3.price as p3 "
        "insert into Out;",
    "count min == max":
        "from every e1=S[kind == 0] -> e2=S[kind == 1]<2:2> -> e3=S[kind == "
        "2] within 20 sec select e1.price as p1, e2[last].price as l2, "
        "e3.price as p3 insert into Out;",
    "count max COUNT_INF":
        "from every e1=S[kind == 0] -> e2=S[kind == 1]<2:> -> e3=S[kind == "
        "2 and price > 50.0] within 20 sec select e1.price as p1, "
        "e2[last].price as l2 insert into Out;",
    "count trailing":
        "from every e1=S[kind == 0] -> e2=S[kind == 1 and price > e1.price]"
        "<2:3> within 20 sec select e1.price as p1, e2[0].price as f2, "
        "e2[last].price as l2 insert into Out;",
    "min-0 count after a unit":
        "from every e1=S[kind == 0] -> e2=S[kind == 2]<0:3> -> e3=S[kind == "
        "1] within 4 sec select e1.price as p1, e2.price as p2, e3.price as "
        "p3 insert into Out;",
    "min-0 count after an absent":
        "from every e1=S[kind == 0] -> not S[kind == 1 and price > 90.0] for "
        "1 sec -> e2=S[kind == 2]<0:2> -> e3=S[kind == 1] within 10 sec "
        "select e1.price as p1, e3.price as p3 insert into Out;",
    "absent mid-chain":
        "from every e1=S[kind == 0 and price > 30.0] -> not S[kind == 1 and "
        "price > e1.price] for 1 sec -> e3=S[kind == 2] within 5 sec "
        "select e1.price as p1, e3.price as p3 insert into Out;",
    "absent trailing (config 3)":
        "from every e1=S[kind == 0 and price > 30.0] -> e2=S[kind == 1 and "
        "price > e1.price] -> not S[kind == 0 and price > e2.price] for "
        "3 sec within 40000 milliseconds select e1.price as p1, e2.price "
        "as p2 insert into Out;",
    "absent chain":
        "from every e1=S[kind == 0] -> not S[kind == 1] for 500 "
        "milliseconds -> not S[kind == 2] for 700 milliseconds select "
        "e1.price as p1 insert into Out;",
    "absent + within":
        "from every e1=S[kind == 0] -> e2=S[kind == 1] -> not S[kind == 2 "
        "and price > 80.0] for 1500 milliseconds within 3 sec select "
        "e1.price as p1, e2.price as p2 insert into Out;",
}

ABSENT = sorted(n for n in WIDENED if "absent" in n)


def _timer_blocks(blocks, parts, attr_names):
    """TIMER blocks (one row a lane, T = 1) after each data block, past
    the block's last event, and one far past the feed's end."""
    out = []
    for b in blocks:
        out.append(b)
        last = int(b["__ts"][b["__valid"]].max()) if b["__valid"].any() \
            else 0
        out.append(jax_timer_block(parts, last + 1_700, attr_names))
    out.append(jax_timer_block(parts, 10 ** 7, attr_names))
    return out


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("name", sorted(WIDENED))
def test_widened_step_equals_jax_and_kernel_model(name, B):
    """JAX build_block_step == the plain step == the kernel model, every
    carry leaf and output, over chained blocks and TIMER blocks."""
    app = STREAM + WIDENED[name]
    parts = 3
    ref = JaxNFA(app, n_partitions=parts, n_slots=4, mesh=None, batch_b=B)
    nfa = CompiledPatternNFA(app, n_partitions=parts, n_slots=4, batch_b=B,
                             device="cpu")
    assert nfa.kprog.reason is None, nfa.kprog.reason
    jstep = jax.jit(build_block_step(ref.spec))
    jc = ref.carry
    tc = tm = _torch_carry({k: np.asarray(v) for k, v in jc.items()})
    blocks = _timer_blocks(_blocks(ref.spec.attr_names, parts, seed=17,
                                   n_blocks=4, n=400),
                           parts, ref.spec.attr_names)
    matches = 0
    for bi, block in enumerate(blocks):
        jc, jy = jstep(jc, block)
        tb = _torch_block(block)
        tc, ty = nfa_block_step_plain(nfa.spec, tc, tb)
        tm, my = nfa_block_step_plain(nfa.spec, tm, tb, kprog=nfa.kprog)
        assert sorted(tc) == sorted(jc) == sorted(tm)
        for k in jc:
            _same(f"{name} B={B} block {bi} carry.{k}", tc[k], jc[k])
            _same(f"{name} B={B} block {bi} model carry.{k}", tm[k], tc[k])
        for n_, g, m, w in zip(OUT_NAMES, ty, my, jy):
            _same(f"{name} B={B} block {bi} {n_}", g, w)
            _same(f"{name} B={B} block {bi} model {n_}", m, g)
        matches += int(np.asarray(jy[0]).sum())
    assert matches > 0, f"{name}: degenerate cell (0 matches)"


@pytest.mark.parametrize("name", ABSENT)
def test_egress_tail_deadline_equals_jax(name):
    """The plain compaction's slab and tail (count, summed dropped, the
    earliest deadline of the slots waiting at an absent unit, 2^31 - 1
    when none) equal the JAX ``pack`` at caps below and above the count,
    after every block, TIMER blocks included."""
    app = STREAM + WIDENED[name]
    ref = JaxNFA(app, n_partitions=3, n_slots=4, mesh=None)
    nfa = CompiledPatternNFA(app, n_partitions=3, n_slots=4, device="cpu")
    jstep = jax.jit(build_block_step(ref.spec))
    jc = ref.carry
    tc = _torch_carry({k: np.asarray(v) for k, v in jc.items()})
    seen = set()
    for bi, block in enumerate(_timer_blocks(
            _blocks(ref.spec.attr_names, 3, seed=5), 3,
            ref.spec.attr_names)):
        jc, jy = jstep(jc, block)
        jcn = {k: np.array(v) for k, v in jc.items()}
        tc, eg = nfa_step_egress(nfa.spec, tc, _torch_block(block),
                                 nfa.kprog, cap=1)
        for cap in (1, 1024):
            want = np.asarray(ref._egress_pack_fn()(
                *[np.asarray(y) for y in jy], jcn["dropped"],
                jcn["slot_state"], jcn["deadline"], cap))
            got = eg.buf if cap == 1 else eg.repack(cap)
            _same(f"{name} block {bi} cap {cap}", got[:-1], want)
            seen.add(int(want[-1, 2]) == 2 ** 31 - 1)
    assert seen == {True, False}, "the tail never held (or always held) " \
        "a deadline"


def _absent_bank_apps(thrs, floor=20.0):
    return [STREAM.replace("(price", "(partition int, price") +
            f"from every e1=S[kind == 0 and price > {t}] -> e2=S[kind == 1 "
            f"and price > e1.price and price > {floor}] -> not S[kind == 0 "
            "and price > e2.price] for 3 sec within 9000 milliseconds "
            "select e1.price as p1, e2.price as p2 insert into Out;"
            for t in thrs]


@pytest.mark.parametrize("K", [2, 8])
def test_bank_thread_model_absent_equals_plain_and_jax(K):
    """The bank thread instance's model with absent units (kills,
    deadlines set on landing and on arming, the deadline pass on dead and
    live events) equals the plain bank step after every block, every
    carry leaf and per-lane output, and the JAX bank's per-pattern counts
    and carry."""
    from test_torch_bank_kernel import BASE, GAP, P, T, _block
    apps = _absent_bank_apps(np.linspace(5, 95, 6))
    tb = CompiledPatternBank(apps, n_partitions=P, n_slots=K,
                             pattern_chunk=3, device="cpu")
    jb = JaxBank(apps, n_partitions=P, n_slots=K, pattern_chunk=3)
    assert tb.nfa.kprog.reason is None, tb.nfa.kprog.reason
    spec, kp, prm = tb.nfa.spec, tb.nfa.kprog, tb._stack_params
    c_plain = c_model = tb._stack_carry
    rng = np.random.default_rng(K)
    total = 0
    for b in range(4):
        raw = _block(rng, BASE + b * T * GAP)
        block = tb.nfa.to_device(raw)
        want = bank_lanes_plain(spec, c_plain, block, prm)
        got = bank_thread_model(spec, c_model, block, prm, kp, 8)
        for k in want[0]:
            assert torch.equal(got[0][k], want[0][k]), (b, k)
        for x, y in zip(got[1:], want[1:]):
            assert torch.equal(x, y), b
        c_plain, c_model = want[0], got[0]
        jcount = np.asarray(jb.process_block(raw))
        assert jcount.tolist() == got[1].sum(dim=1).tolist(), b
        total += int(got[1].sum())
    for ci, jcar in enumerate(jb.carries):
        for k in jcar:
            x, y = np.asarray(jcar[k]), c_model[k][ci].numpy()
            assert x.dtype == y.dtype and np.array_equal(
                x.view(np.int32), y.view(np.int32)), (ci, k)
    assert total > 0


def test_kernel_prog_new_fields_are_what_parse_reads():
    """A Python mirror of csrc's ``parse`` over count and absent
    programs: the header flags and occupancy bound, each unit's kind,
    count bounds, wait, landing (``_land_static``) and the counts that
    append while a slot waits there, and each count row's layout (first
    and last banks, the __n lane, the e[k] banks, the e[last-j] banks and
    the last-bank lanes they shift from)."""
    for name in WIDENED:
        nfa = CompiledPatternNFA(STREAM + WIDENED[name], n_partitions=2,
                                 device="cpu")
        spec = nfa.spec
        h = parse_prog(kernel_prog(spec, nfa.kprog))
        kinds = {u.kind for u in spec.units}
        assert (h["has_count"], h["has_absent"]) == \
            (int("count" in kinds), int("absent" in kinds)), name
        assert h["occ_hi"] == (spec.every_group_end
                               if spec.units[0].kind == "count" else -1)
        apps = {}
        for j, u in enumerate(spec.units):
            t, live0, done = _land_static(spec, j)
            if u.kind == "count" and not done:
                apps.setdefault(t, []).append(j)
        for j, (u, w) in enumerate(zip(spec.units, h["units"])):
            t, live0, _d = _land_static(spec, j)
            app = (apps.get(j, []) + [-1, -1])[:2]
            assert w == (UNIT_KINDS.index(u.kind), u.stream_a, u.cond_a,
                         u.row_a, u.min_count, u.max_count, u.waiting_ms, t,
                         int(live0), *app), (name, j)
        count_rows = {u.row_a for u in spec.units if u.kind == "count"}
        for r, x in enumerate(h["rows"]):
            if r not in count_rows:
                assert x is None, (name, r)
                continue
            nf, nl, nlane, ib, mb, src = x
            assert (nf, nl, nlane) == (spec.n_first[r], spec.n_last[r],
                                       spec.n_lane[r]), (name, r)
            assert ib == tuple(spec.idx_banks[r])
            assert mb == tuple(s for _j, s in sorted(spec.lastk_banks[r]))
            assert src == (tuple(spec.m_src[r]) if mb else ())
    banks = parse_prog(kernel_prog(*_spec_kprog("count banks")))["rows"][1]
    # e2: first bank, last bank, e[1] and e[3] banks, e[last-1] and
    # e[last-2] shifting from the last bank's price lane, then __n
    assert banks == (1, 1, 6, ((1, 2, 1), (3, 3, 1)), (4, 5), (1,))
    inf = parse_prog(kernel_prog(*_spec_kprog("count max COUNT_INF")))
    assert inf["units"][1][4:6] == (2, COUNT_INF)


def _spec_kprog(name):
    nfa = CompiledPatternNFA(STREAM + WIDENED[name], n_partitions=2,
                             device="cpu")
    return nfa.spec, nfa.kprog


def test_widened_shapes_are_in_class_and_the_rest_is_not():
    """Every widened shape (and chip_smoke.py's phase-5 cases) is inside
    the kernel's class; a leading min-0 count, a leading absent and
    SEQUENCE with an absent unit are inside the step's class and the
    pattern bank's (the widened instances); a kleene count reading its
    own [last] bank is inside both (its chain-length guard a condition
    program); one reading it through a transcendental is outside
    both."""
    for text in list(WIDENED.values()):
        nfa = CompiledPatternNFA(STREAM + text, n_partitions=2, device="cpu")
        assert kernel_class_reason(nfa.spec) is None
        assert nfa.kprog.reason is None, (text, nfa.kprog.reason)
    for name, text in chip_smoke.WIDE_CASES.items():
        nfa = CompiledPatternNFA(text, n_partitions=2, device="cpu")
        assert nfa.kprog.reason is None, (name, nfa.kprog.reason)
    both_wide = {
        "leading min-0 count": ("from e1=S[kind == 0]<0:3> -> e2=S[kind == "
                                "1] select e2.price as p insert into Out;",
                                "min-0"),
        "leading absent": ("from not S[kind == 1] for 1 sec -> e2=S[kind == "
                           "0] select e2.price as p insert into Out;",
                           "leading absent"),
        "SEQUENCE absent": ("from every e1=S[kind == 0], not S[kind == 1] "
                            "for 1 sec select e1.price as p insert into "
                            "Out;", "SEQUENCE"),
    }
    for name, (text, word) in both_wide.items():
        nfa = CompiledPatternNFA(STREAM + text, n_partitions=2, device="cpu")
        assert nfa.kprog.reason is None, (name, nfa.kprog.reason)
        assert bank_class_reason(nfa.spec, nfa.kprog) is None, name
        assert kernel_wide(nfa.spec, nfa.kprog), name
        assert word in _structural_wide(nfa.spec), name
    own_last = CompiledPatternNFA(
        STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and price > "
        "e2[last].price]<1:3> -> e3=S[kind == 2] select e1.price as p "
        "insert into Out;", n_partitions=2, device="cpu")
    assert own_last.kprog.reason is None, own_last.kprog.reason
    assert any(own_last.kprog.prog)
    assert bank_class_reason(own_last.spec, own_last.kprog) is None
    outside = {
        "own [last] in a count": (
            "from every e1=S[kind == 0] -> e2=S[kind == 1 and "
            "math:log(price) > e2[last].price]<1:3> -> e3=S[kind == 2] "
            "select e1.price as p insert into Out;", "transcendental"),
    }
    for name, (text, word) in outside.items():
        nfa = CompiledPatternNFA(STREAM + text, n_partitions=2, device="cpu")
        assert nfa.kprog.reason is not None and word in nfa.kprog.reason, \
            (name, nfa.kprog.reason)


def test_bank_geometry_routes_by_class():
    """A count bank and an absent bank go to the thread instance, whose
    shared memory holds a deadline column, with absent units, and four
    more words a slot (cnt_cur, cnt_prev, state and start), with count
    units, beside the capture, enter and seq columns, and a candidate
    mask for each condition; a count bank past K = 16 goes to the group
    instance (a dispatch rule of the spec's shape)."""
    base = bank_geometry(8, 64, 2, 2, 5, 5, 120)
    absent = bank_geometry(8, 64, 2, 2, 5, 5, 120, absent=True)
    count = bank_geometry(8, 64, 2, 2, 5, 5, 120, count=True)
    assert base.instance == absent.instance == count.instance == "thread"
    assert absent.smem - base.smem == 256 * 8 * 4
    assert count.smem - base.smem == 256 * 8 * 4 * 4
    # one candidate mask a condition: 128 bits for each of 32 lanes
    three = bank_geometry(8, 64, 2, 2, 5, 5, 120, n_cond=3)
    assert three.smem - base.smem == 2 * 32 * 4 * 4
    assert (absent.TT, absent.groups) == (base.TT, base.groups) == \
        (count.TT, count.groups)
    wide = bank_geometry(17, 64, 2, 2, 5, 5, 120, count=True)
    assert wide.instance == "group" and wide.TT == 0
    # through the bank: config 3 and a count on the thread instance, the
    # count at K = 17 on the group instance
    ab = CompiledPatternBank(_absent_bank_apps([10.0, 20.0]), n_partitions=4,
                             n_slots=8, device="cpu")
    cb = CompiledPatternBank(
        [chip_smoke.count_bank_app(t) for t in (10.0, 20.0)], n_partitions=4,
        n_slots=8, device="cpu")
    for bank, K, want in ((ab, 8, "thread"), (cb, 8, "thread"),
                          (cb, 17, "group")):
        spec, kp = bank.nfa.spec, bank.nfa.kprog
        assert kp.reason is None, kp.reason
        kinds = {u.kind for u in spec.units}
        g = bank_geometry(K, 64, len(kp.kern_attrs), spec.n_rows * spec.n_caps,
                          sum(len(q) for q in kp.pcmp), len(kp.param_names),
                          len(kernel_prog(spec, kp)),
                          count="count" in kinds, absent="absent" in kinds,
                          n_cond=len(kp.cmp))
        assert g.instance == want


def _jax_host_rows(text, feed):
    """The JAX package's host engine over the feed → rows sorted."""
    rt = JaxManager().create_siddhi_app_runtime(
        "@app:engine('host')\n" + text)
    out = []
    rt.add_callback("Out", JaxCallback(
        lambda evs: out.extend([e.timestamp] + list(e.data) for e in evs)))
    rt.start()
    h = rt.get_input_handler("S")
    for cols, ts, *_rest in feed:
        h.send_batch(cols, timestamps=ts)
    rt.shutdown()
    return sorted(tuple(r) for r in out)


def test_phase10_reference_equals_jax_host_engine():
    """chip_smoke.py's count_reference (BASELINE config 4 per key) equals
    the JAX host engine on a small stream."""
    chunks = chip_smoke.make_count_chunks(0, 2, n_keys=60, chunk=3000)
    want = _jax_host_rows(chip_smoke.COUNT_APP, chunks)
    got = [tuple(r) for r in chip_smoke.count_reference(chunks)]
    assert len(want) > 20
    assert got == [(t, float(np.float32(a)), float(np.float32(b)),
                    float(np.float32(c))) for t, a, b, c in want]


def test_phase11_reference_equals_jax_bank():
    """chip_smoke.py's absent_block_reference (BASELINE config 3 over
    round-robin lanes, per block and pattern) equals the JAX package's
    pattern bank on the same blocks.  (The JAX host engine is no
    reference for config 3: on these lanes it emits no absent match at
    all, where its device engine emits the bank's matches plus those its
    TIMER rows complete after a lane's last event.)"""
    P_, T_, n_blocks = 24, 16, 3
    thrs = np.linspace(40.0, 90.0, 4)
    blocks = chip_smoke.bank_blocks(np.random.default_rng(1), n_blocks, P=P_,
                                    T=T_, gap=10_000)
    want, price, _kind, done = chip_smoke.absent_block_reference(
        blocks, thrs, floor=30.0, gap=10_000)
    jb = JaxBank([chip_smoke.absent_bank_app(t, floor=30.0) for t in thrs],
                 n_partitions=P_, n_slots=8, pattern_chunk=2)
    got = np.stack([np.asarray(jb.process_block(b)) for b in blocks])
    assert got.tolist() == want.tolist()
    assert want.sum() > 20
    assert int((price[done >= 0] > np.float32(thrs[0])).sum()) == \
        int(want[:, 0].sum())
    assert jb.total_dropped() == 0
