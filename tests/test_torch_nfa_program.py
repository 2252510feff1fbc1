"""Capture-reading conditions as programs inside the CUDA NFA kernels,
held on the CPU against the JAX package.

csrc/nfa_step.cuh's ``eval_prog`` (K2's simple and widened instances,
the gang K12 and the bank's K3, its thread and group instances) cannot
run here.  What it
computes is held by its CPU model, ``ops/nfa._model_program`` inside the
kernel model (``nfa_block_step_plain(..., kprog=)``), bit for bit:

- the lowering (plan/nfa_program.py): the words ``parse`` reads for each
  operand (event lane, capture lane, pattern constant, constant), each
  op, and the guards (a nullable row's validity lane, the ``[last]``
  rewrite's chain length), and the program section of the table;
- for each form the kernels now take — the Quick start ratio, an offset
  (``(e1.price + 5.0) <= price``), ``%``, ``/`` (a constant over a lane
  too), unary minus, ``abs``, ``floor``/``ceil``, ``sqrt``/``round``,
  ``maximum``/``minimum``, ``or`` and ``not`` around a capture compare, a
  nullable row after ``or``, a kleene count reading its own ``[last]``,
  the ratio in SEQUENCE and a program in unit 0 (the widened instance) —
  over chained blocks with TIMER blocks between them and NaN, zero and
  negative prices among them, the JAX package's ``build_block_step``, the
  port's plain step and the kernel model agree on every carry leaf and
  output, at B = 1 and B = 4;
- the Quick start and the temperature rule through
  ``SiddhiManager(device="cpu")`` give the JAX package's rows;
- the ratio bank (8 patterns) equals the JAX bank, through the group
  instance's CPU model;
- each form left out keeps its named reason.
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
from siddhi_tpu_torch import SiddhiManager, StreamCallback  # noqa: E402
from siddhi_tpu_torch.ops.nfa import (bank_class_reason,  # noqa: E402
                                      bank_geometry, bank_lanes_plain,
                                      bank_thread_model,
                                      kernel_class_reason, kernel_prog,
                                      kernel_wide, nfa_block_step_plain)
from siddhi_tpu_torch.ops.pack import pack_blocks  # noqa: E402
from siddhi_tpu_torch.plan import nfa_program as npg  # noqa: E402
from siddhi_tpu_torch.plan.nfa_compiler import (  # noqa: E402
    CompiledPatternBank, CompiledPatternNFA)

from test_torch_bank_kernel import parse_prog  # noqa: E402
from test_torch_nfa_step import (OUT_NAMES, _same, _torch_block,  # noqa: E402
                                 _torch_carry)

STREAM = "define stream S (price float, kind int);\n"
_SEL2 = " within 5 sec select e1.price as p1, e2.price as p2 insert into Out;"


def _pair2(cond: str) -> str:
    return (STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and " +
            cond + "]" + _SEL2)


#: the forms the kernels now take, a few to an app; the value: (app,
#: NaN prices)
FORMS = {
    "ratio": (STREAM + "from every e1=S[kind == 0 and price > 50.0] -> "
              "e2=S[kind == 1 and price > e1.price * 1.05]" + _SEL2, False),
    "offset": (_pair2("(e1.price + 5.0) <= price"), False),
    "% and /": (_pair2("price % 7.0 > e1.price % 5.0 and price / e1.price "
                       "> 0.5"), True),
    "unary minus, a constant over a lane": (
        _pair2("-price < -e1.price and 100.0 / price < e1.price / 7.0"),
        True),
    "abs, floor, ceil": (_pair2("math:abs(price - 50.0) < e1.price * 0.5 "
                                "and math:floor(price / 10.0) * 10.0 > "
                                "e1.price - 30.0 and math:ceil(price) < "
                                "e1.price + 20.0"), False),
    "sqrt, round, maximum, minimum": (
        _pair2("math:sqrt(price) * 10.0 > e1.price and math:round(price) != "
               "e1.price and maximum(price, 40.0) > e1.price and "
               "minimum(price, 90.0) < e1.price + 30.0"), True),
    "or, not": (STREAM + "from every e1=S[kind == 0] -> e2=S[kind != 0 and "
                "(price > e1.price or kind == 2) and not (price < e1.price "
                "* 0.9)]" + _SEL2, True),
    "nullable after or": (
        STREAM + "from every e1=S[kind == 0] -> (e2=S[kind == 1] or "
        "e3=S[kind == 2]) -> e4=S[kind == 0 and price > e2.price] within "
        "5 sec select e1.price as p1, e2.price as p2, e4.price as p4 insert "
        "into Out;", False),
    "own last": (
        STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and "
        "(e2[last].price is null or price > e2[last].price)]<1:3> -> "
        "e3=S[kind == 2] within 5 sec select e1.price as p1, e2[last].price "
        "as l2, e3.price as p3 insert into Out;", False),
    "sequence ratio": (
        STREAM + "from every e1=S[kind == 0 and price > 30.0], e2=S[kind == "
        "1 and price > e1.price * 1.05] select e1.price as p1, e2.price as "
        "p2 insert into Out;", False),
    "unit 0 own last": (
        STREAM + "from every e1=S[kind == 0 and (e1[last].price is null or "
        "price < e1[last].price)]<1:3> -> e2=S[kind == 1 and price > "
        "e1[last].price] within 5 sec select e1[0].price as f1, "
        "e1[last].price as l1, e2.price as p2 insert into Out;", False),
}


def _blocks(attr_names, parts, seed, nan, n_blocks=3, n=300):
    """Chained [P, T] blocks of one feed (kinds 0..2; prices in [-5, 100)
    with a few zeros, and with ``nan`` NaNs), a TIMER block past each
    block and one far past the end."""
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, parts, n).astype(np.int64)
    price = rng.uniform(-5, 100, n).astype(np.float32)
    price[rng.random(n) < 0.03] = 0.0
    if nan:
        price[rng.random(n) < 0.05] = np.nan
    cols = {"price": price,
            "kind": rng.integers(0, 3, n).astype(np.float32)}
    ts = 1_000_000 + np.cumsum(rng.integers(0, 500, n)).astype(np.int64)
    splits = np.array_split(np.arange(n), n_blocks)
    data = [pack_blocks(pids[ix], {a: cols[a][ix] for a in attr_names},
                        ts[ix], np.zeros(len(ix), np.int32), parts,
                        base_ts=1_000_000) for ix in splits]
    T = max(b["__ts"].shape[1] for b in data)
    out = []
    for ix, b in zip(splits, data):
        # one T for every data block (one trace of the JAX step): invalid
        # rows at the lane's last ts, as the plain step pads
        pad = T - b["__ts"].shape[1]
        out.append({k: np.pad(v, ((0, 0), (0, pad)),
                              mode="edge" if k == "__ts" else "constant")
                    for k, v in b.items()})
        out.append(jax_timer_block(parts, int(ts[ix[-1]]) - 1_000_000 +
                                   1_200, attr_names))
    out.append(jax_timer_block(parts, 10 ** 7, attr_names))
    return out


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("name", sorted(FORMS))
def test_program_form_equals_jax_and_kernel_model(name, B):
    """JAX build_block_step == the plain step == the kernel model, every
    carry leaf and output, over chained blocks and TIMER blocks."""
    text, nan = FORMS[name]
    ref = JaxNFA(text, n_partitions=6, n_slots=4, mesh=None, batch_b=B)
    nfa = CompiledPatternNFA(text, n_partitions=6, n_slots=4, batch_b=B,
                             device="cpu")
    assert kernel_class_reason(nfa.spec) is None
    assert nfa.kprog.reason is None, nfa.kprog.reason
    assert any(nfa.kprog.prog), name
    jstep = jax.jit(build_block_step(ref.spec))
    jc = ref.carry
    tc = tm = _torch_carry({k: np.asarray(v) for k, v in jc.items()})
    matches = 0
    for bi, block in enumerate(_blocks(ref.spec.attr_names, 6, seed=31,
                                       nan=nan)):
        jc, jy = jstep(jc, block)
        tb = _torch_block(block)
        tc, ty = nfa_block_step_plain(nfa.spec, tc, tb)
        tm, my = nfa_block_step_plain(nfa.spec, tm, tb, kprog=nfa.kprog)
        for k in jc:
            _same(f"{name} B={B} block {bi} carry.{k}", tc[k], jc[k])
            _same(f"{name} B={B} block {bi} model carry.{k}", tm[k], tc[k])
        for n_, g, m, w in zip(OUT_NAMES, ty, my, jy):
            _same(f"{name} B={B} block {bi} {n_}", g, w)
            _same(f"{name} B={B} block {bi} model {n_}", m, g)
        matches += int(np.asarray(jy[0]).sum())
    assert matches > 0, f"{name}: degenerate cell (0 matches)"


def _kp(text):
    return CompiledPatternNFA(text, n_partitions=2, device="cpu").kprog


def test_lowering_words():
    """The words ``parse`` reads: each operand and op of the Quick start
    ratio and of the guards, and the table's program section."""
    nfa = CompiledPatternNFA(FORMS["ratio"][0], n_partitions=2,
                             device="cpu")
    kp = nfa.kprog
    assert kp.prog[0] == () and kp.cmp[1] == ()
    assert npg.describe(kp.prog[1]) == ["ev:0", "cap:0", "k:0", "mul:0",
                                        "cmp:2"]
    assert kp.kern_attrs[0] == "price"
    assert kp.pconst[1] == (float(np.float32(1.05)),)
    assert not kernel_wide(nfa.spec, kp)    # the simple instance
    h = parse_prog(kernel_prog(nfa.spec, kp))
    assert h["prog"] == kp.prog
    assert h["pconst"] == (int(np.float32(1.05).view(np.int32)),)
    # constants of two conditions share the section: the second's index
    # is rebased past the first's
    two = CompiledPatternNFA(
        STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and price > "
        "e1.price * 2.0] -> e3=S[kind == 2 and price < e2.price - 3.0] "
        "select e1.price as p insert into Out;", n_partitions=2,
        device="cpu")
    h = parse_prog(kernel_prog(two.spec, two.kprog))
    assert [npg.describe(q) for q in h["prog"]] == [
        [], ["ev:0", "cap:0", "k:0", "mul:0", "cmp:2"],
        ["ev:0", "cap:1", "k:1", "sub:0", "cmp:0"]]
    assert h["pconst"] == tuple(int(np.float32(c).view(np.int32))
                                for c in (2.0, 3.0))
    # every op code, through the forms
    ops = {w & 0xff for name in FORMS
           for q in _kp(FORMS[name][0]).prog for w in q}
    assert ops >= set(range(npg.OP_ADD, npg.OP_NOT + 1)) - {npg.OP_PRM}
    # the guards: e2's __matched lane > 0 after `or`, the chain length of
    # a count's own [last]
    nl = CompiledPatternNFA(FORMS["nullable after or"][0], n_partitions=2,
                            device="cpu")
    row = nl.ref_to_side["e2"].row
    lane = nl.spec.matched_lane[row]
    C = nl.spec.n_caps
    c4 = nl.spec.units[2].cond_a
    assert npg.describe(nl.kprog.prog[c4]) == [
        f"cap:{row * C + lane}", "k:0", "cmp:2"]
    assert nl.kprog.pconst[c4] == (0.0,)
    assert nl.kprog.cmp[c4]            # price > e2.price stays a table
    ol = CompiledPatternNFA(FORMS["own last"][0], n_partitions=2,
                            device="cpu")
    row = ol.ref_to_side["e2"].row
    n_lane = ol.spec.n_lane[row] + row * ol.spec.n_caps
    words = npg.describe(ol.kprog.prog[ol.spec.units[1].cond_a])
    assert words[:3] == [f"cap:{n_lane}", "k:0", "cmp:4"]   # __cnt == 0
    assert words[-5:-1] == [f"cap:{n_lane}", "k:1", "cmp:3", "and:0"]
    # a pattern constant is a program operand in a bank
    apps = [FORMS["ratio"][0].replace("1.05", str(r)) for r in (1.0, 1.1)]
    bank = CompiledPatternBank(apps, n_partitions=2, device="cpu")
    assert npg.describe(bank.nfa.kprog.prog[1]) == ["ev:0", "cap:0",
                                                    "prm:3", "mul:0",
                                                    "cmp:2"]


def test_program_forms_instances():
    """A program outside unit 0 runs on the simple instance; one in unit
    0 (reading slot 0 as the plain step does) on the widened one."""
    for name, (text, _nan) in FORMS.items():
        nfa = CompiledPatternNFA(text, n_partitions=2, device="cpu")
        c0 = nfa.spec.units[0].cond_a
        if name == "unit 0 own last":
            assert nfa.kprog.prog[c0] and kernel_wide(nfa.spec, nfa.kprog)
        elif name in ("ratio", "offset", "% and /", "own last"):
            assert not kernel_wide(nfa.spec, nfa.kprog), name


QUICK = ("define stream Trades (symbol string, price float, volume long);\n"
         "@info(name='spikes')\n"
         "from every e1=Trades[price > 100.0] -> e2=Trades[price > e1.price "
         "* 1.05]\n    within 10 sec\n"
         "select e1.symbol as symbol, e1.price as p1, e2.price as p2\n"
         "insert into Alerts;")
TEMP = ("define stream Temp (room int, temp double);\n"
        "@info(name='rise')\n"
        "from every e1=Temp -> e2=Temp[e1.room == room and (e1.temp + 5.0) "
        "<= temp] within 1 min\n"
        "select e1.room as room, e1.temp as t1, e2.temp as t2\n"
        "insert into Alerts;")


def _feed(app):
    rng = np.random.default_rng(5)
    n = 240
    ts = 1_000 + np.cumsum(rng.integers(0, 2_000, n)).astype(np.int64)
    if app is QUICK:
        return "Trades", {
            "symbol": np.asarray([f"S{i}" for i in
                                  rng.integers(0, 5, n)], object),
            "price": rng.uniform(90, 130, n).astype(np.float32),
            "volume": rng.integers(1, 100, n).astype(np.int64)}, ts
    return "Temp", {"room": rng.integers(0, 4, n).astype(np.int32),
                    "temp": rng.uniform(10, 40, n)}, ts


def _rows(manager, callback, app, **kw):
    rt = manager(**kw).create_siddhi_app_runtime(
        "@app:playback @app:engine('device') " + app)
    out = []
    rt.add_callback("Alerts", callback(
        lambda evs: out.extend((e.timestamp,) + tuple(e.data) for e in evs)))
    rt.start()
    try:
        stream, cols, ts = _feed(app)
        rt.get_input_handler(stream).send_batch(cols, timestamps=ts)
        rt.flush()
        qr = rt.query_runtimes["spikes" if app is QUICK else "rise"]
        return sorted(out), qr.backend
    finally:
        rt.shutdown()


@pytest.mark.parametrize("app", ["quick start", "temperature"])
def test_apps_equal_jax_rows(app):
    """The README's Quick start and the temperature rule through the
    port's device engine on the CPU give the JAX package's rows."""
    text = QUICK if app == "quick start" else TEMP
    want, _ = _rows(JaxManager, JaxCallback, text)
    got, route = _rows(SiddhiManager, StreamCallback, text, device="cpu")
    assert route == "device"
    assert len(want) > 10
    assert got == want


def test_ratio_bank_equals_jax_bank():
    """The Quick start as an 8-pattern bank (ratios 1.00..1.07,
    thresholds 5..12) routes to the thread instance (to the group
    instance at K = 17); the kernels' CPU model (each condition from the
    kernel's inputs, its program included) and the thread instance's
    model equal the plain bank step and the JAX bank, per pattern and
    block and carry leaf."""
    P, T = 16, 24
    apps = [FORMS["ratio"][0].replace("50.0", f"{5.0 + i}")
            .replace("1.05", f"{1.0 + 0.01 * i:.2f}") for i in range(8)]
    bank = CompiledPatternBank(apps, n_partitions=P, n_slots=4,
                               pattern_chunk=4, device="cpu")
    jb = JaxBank(apps, n_partitions=P, n_slots=4, pattern_chunk=4)
    spec, kp = bank.nfa.spec, bank.nfa.kprog
    assert bank_class_reason(spec, kp) is None
    assert any(kp.prog)
    assert bank_geometry(4, T, len(kp.kern_attrs), 2, 1, 2,
                         len(kernel_prog(spec, kp))).instance == "thread"
    assert bank_geometry(17, T, len(kp.kern_attrs), 2, 1, 2,
                         len(kernel_prog(spec, kp))).instance == "group"
    rng = np.random.default_rng(3)
    c_plain = c_model = bank._stack_carry
    total = 0
    for b in range(3):
        pids = np.tile(np.arange(P, dtype=np.int64), T)
        j = np.repeat(np.arange(T, dtype=np.int64), P)
        ts = 1_000_000 + b * T * 700 + j * 700 + pids * 40
        price = rng.uniform(0, 100, P * T).astype(np.float32)
        price[rng.random(P * T) < 0.03] = np.nan
        raw = pack_blocks(pids, {"price": price, "kind": rng.integers(
            0, 2, P * T).astype(np.float32)}, ts, np.zeros(P * T, np.int32),
            P, base_ts=1_000_000)
        block = bank.nfa.to_device(raw)
        want = bank_lanes_plain(spec, c_plain, block, bank._stack_params)
        got = bank_lanes_plain(spec, c_model, block, bank._stack_params,
                               kprog=kp)
        thr = bank_thread_model(spec, c_model, block, bank._stack_params,
                                kp, 4)
        for k in want[0]:
            assert torch.equal(got[0][k], want[0][k]), (b, k)
            assert torch.equal(thr[0][k], want[0][k]), (b, k)
        for x, y, z in zip(got[1:], want[1:], thr[1:]):
            assert torch.equal(x, y) and torch.equal(z, y), b
        jc = np.asarray(jb.process_block(raw))
        assert jc.tolist() == got[1].sum(dim=1).tolist(), b
        c_plain, c_model = want[0], got[0]
        total += int(jc.sum())
    for ci, jcar in enumerate(jb.carries):
        for k in jcar:
            x, y = np.asarray(jcar[k]), c_model[k][ci].numpy()
            assert x.dtype == y.dtype and np.array_equal(
                x.view(np.int32), y.view(np.int32)), (ci, k)
    assert total > 0


#: forms left out, each with a word of its reason
LEFT_OUT = {
    "transcendental": (_pair2("math:log(price) > e1.price"),
                       "transcendental math:log"),
    "power": (_pair2("math:power(price, 2.0) > e1.price"),
              "transcendental math:power"),
    "INT arithmetic": (_pair2("kind > e1.kind + 1"), "INT/LONG arithmetic"),
    "ifThenElse": (_pair2("ifThenElse(price > 5.0, price, 0.0) > e1.price"),
                   "the function ifThenElse"),
    "cast": (_pair2("cast(price, 'double') > e1.price"),
             "the function cast"),
    "is null": (_pair2("(e1.price is null or price > e1.price)"),
                "`is null` outside the [last] rewrite"),
    "deeper than the stack": (
        _pair2("price > (e1.price + (price + (e1.price + (price + (e1.price "
               "+ (price + (e1.price + (price + 1.0))))))))"),
        "deeper than 8"),
    "longer than the block": (
        _pair2("price > e1.price" + " + price" * 32), "more than 64"),
}


@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_forms_left_out_keep_their_reason(name):
    text, word = LEFT_OUT[name]
    kp = _kp(text)
    assert kp.reason is not None and word in kp.reason, kp.reason


def test_bank_first_condition_program_keeps_its_reason():
    """A program in unit 0's condition (pattern constants in arithmetic)
    is inside the step's class and the bank's: the bank runs it on its
    widened instance, which reads unit 0's condition against slot 0 as
    the step's does."""
    apps = [STREAM + f"from every e1=S[kind == 0 and price * 2.0 > {t}] -> "
            "e2=S[kind == 1 and price > e1.price] select e1.price as p1 "
            "insert into Out;" for t in (10.0, 60.0)]
    bank = CompiledPatternBank(apps, n_partitions=4, device="cpu")
    kp = bank.nfa.kprog
    assert kp.reason is None, kp.reason
    assert bank_class_reason(bank.nfa.spec, kp) is None
    assert kernel_wide(bank.nfa.spec, kp)
