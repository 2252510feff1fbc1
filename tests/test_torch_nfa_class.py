"""The CUDA NFA step's widened class — the JAX step's whole structural
class — held on the CPU against the JAX package.

csrc/nfa_step.cu's widened template instance (K2, and K12 through the
gang) cannot run here.  What it computes is held by its CPU model, the
plain step driven through the kernel program (``nfa_block_step_plain(...,
kprog=)``: the gate word and the compare tables), bit for bit:

- for each widened kind — logical ``and`` / ``or`` units (leading and
  mid-chain), SEQUENCE (simple, count, logical and absent units, the
  single-shot form), an ``every`` group past the leading unit, mid-chain
  and trailing ``every``, leading min-0 counts (PATTERN and SEQUENCE with
  its every-min-0 seed), leading absent units, telemetry and
  ``<capture> <cmp> <constant>`` compares (with the string rewrite's null
  guard) — over chained blocks with TIMER blocks between them, the JAX
  package's ``build_block_step``, the port's plain step and the kernel
  model agree on every carry leaf and every output, at B = 1 and B = 4;
- ``kernel_class_reason(spec)`` and ``kprog.reason`` are None for each,
  and each runs the widened instance;
- the program table's widened words (header, each unit's side B, the
  mid-chain groups, the capture-to-constant table) are what the C
  ``parse`` reads;
- the condition forms left out keep their reasons.
"""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from siddhi_tpu.ops.nfa import build_block_step  # noqa: E402
from siddhi_tpu.ops.nfa import \
    make_timer_block as jax_timer_block  # noqa: E402
from siddhi_tpu.plan.nfa_compiler import \
    CompiledPatternNFA as JaxNFA  # noqa: E402
from siddhi_tpu_torch.ops.nfa import (CMP_OPS, MAX_MID_EVERY,  # noqa: E402
                                      UNIT_KINDS, bank_class_reason,
                                      kernel_class_reason, kernel_flags,
                                      kernel_prog, kernel_wide,
                                      nfa_block_step_plain)
from siddhi_tpu_torch.ops.pack import pack_blocks  # noqa: E402
from siddhi_tpu_torch.plan.nfa_compiler import \
    CompiledPatternNFA  # noqa: E402

from test_torch_bank_kernel import parse_prog  # noqa: E402
from test_torch_nfa_step import (OUT_NAMES, _same, _torch_block,  # noqa: E402
                                 _torch_carry)

STREAM = "define stream S (price float, kind int);\n"
SSTREAM = "define stream S (sym string, price float, kind int);\n"

#: one app per widened kind (telemetry: TELEMETRY below)
CLASS = {
    "logical and":
        STREAM + "from every e1=S[kind == 0] -> (e2=S[kind == 1 and price > "
        "e1.price] and e3=S[kind == 2]) -> e4=S[kind == 0 and price < "
        "e1.price] within 20 sec select e1.price as p1, e2.price as p2, "
        "e3.price as p3, e4.price as p4 insert into Out;",
    "logical or":
        STREAM + "from every e1=S[kind == 0 and price > 50.0] -> (e2=S[kind "
        "== 1 and price > e1.price] or e3=S[kind == 2 and price < "
        "e1.price]) select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into Out;",
    "logical leading":
        STREAM + "from every (e1=S[kind == 0] and e2=S[kind == 1]) -> "
        "e3=S[kind == 2 and price > e1.price] within 5 sec select e1.price "
        "as p1, e2.price as p2, e3.price as p3 insert into Out;",
    "sequence":
        STREAM + "from every e1=S[kind == 0 and price > 50.0], e2=S[kind == 1 "
        "and price > e1.price], e3=S[kind == 2] within 10 sec select "
        "e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;",
    "sequence count":
        STREAM + "from every e1=S[kind == 0], e2=S[kind == 1]<1:3>, "
        "e3=S[kind == 2] select e1.price as p1, e2[last].price as l2, "
        "e3.price as p3 insert into Out;",
    "sequence logical":
        STREAM + "from every e1=S[kind == 0], (e2=S[kind == 1] or e3=S[kind "
        "== 2]) select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into Out;",
    "sequence absent":
        STREAM + "from every e1=S[kind == 0], not S[kind == 1] for 1 sec "
        "select e1.price as p1 insert into Out;",
    "sequence once":
        STREAM + "from e1=S[kind == 0], e2=S[kind != 0] select e1.price as "
        "p1, e2.price as p2 insert into Out;",
    "every group":
        STREAM + "from every (e1=S[kind == 0] -> e2=S[kind == 1]) -> "
        "e3=S[kind == 2 and price > e1.price] within 5 sec select e1.price "
        "as p1, e2.price as p2, e3.price as p3 insert into Out;",
    "mid every":
        STREAM + "from e1=S[kind == 0] -> every e2=S[kind == 1 and price > "
        "e1.price] -> e3=S[kind == 2] within 10 sec select e1.price as p1, "
        "e2.price as p2, e3.price as p3 insert into Out;",
    "mid every group":
        STREAM + "from every e1=S[kind == 0] -> every (e2=S[kind == 1] -> "
        "e3=S[kind == 2]) -> e4=S[kind == 0 and price > e1.price] within "
        "6 sec select e1.price as p1, e3.price as p3, e4.price as p4 insert "
        "into Out;",
    "tail every logical":
        STREAM + "from every e1=S[kind == 0 and price > 50.0] -> (e2=S[kind "
        "== 1 and price > e1.price] or e3=S[kind == 2 and price < "
        "e1.price]) -> every e4=S[kind == 1 and price > 80.0] within 10 sec "
        "select e1.price as p1, e2.price as p2, e3.price as p3, e4.price "
        "as p4 insert into Out;",
    "tail every":
        STREAM + "from e1=S[kind == 0] -> every e2=S[kind == 1 and price > "
        "e1.price] within 20 sec select e1.price as p1, e2.price as p2 "
        "insert into Out;",
    "leading min-0":
        STREAM + "from e1=S[kind == 0]<0:3> -> e2=S[kind == 1] within 4 sec "
        "select e1[0].price as f1, e1[last].price as l1, e2.price as p2 "
        "insert into Out;",
    "leading min-0 every":
        STREAM + "from every e1=S[kind == 0]<0:2> -> e2=S[kind == 1 and price "
        "> 30.0] within 4 sec select e1[last].price as l1, e2.price as p2 "
        "insert into Out;",
    "sequence min-0 every":
        STREAM + "from every e1=S[kind == 0]<0:3>, e2=S[kind == 1] select "
        "e1[0].price as f1, e2.price as p2 insert into Out;",
    "sequence min-0 max 1":
        STREAM + "from every e1=S[kind == 0]<0:1>, e2=S[kind == 1] select "
        "e1.price as f1, e2.price as p2 insert into Out;",
    "leading absent":
        STREAM + "from not S[kind == 1] for 1 sec -> e2=S[kind == 0] select "
        "e2.price as p2 insert into Out;",
    "leading absent every":
        STREAM + "from every not S[kind == 1 and price > 50.0] for 800 "
        "milliseconds -> e2=S[kind == 0] -> e3=S[kind == 2] within 5 sec "
        "select e2.price as p2, e3.price as p3 insert into Out;",
    "capture constant":
        STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and e1.price "
        "> 40.0 and price > e1.price] -> e3=S[kind == 2 and 70.0 >= "
        "e2.price] within 8 sec select e1.price as p1, e2.price as p2, "
        "e3.price as p3 insert into Out;",
    "string guard":
        SSTREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and sym == "
        "e1.sym] within 6 sec select e1.price as p1, e2.price as p2 insert "
        "into Out;",
}

#: kinds also run with the telemetry leaf
TELEMETRY = ("logical or", "sequence", "every group", "leading absent",
             "tail every logical", "mid every", "leading min-0")


def _blocks(attr_names, parts, seed, n_blocks=4, n=480):
    """Chained [P, T] blocks of one feed: kinds 0..2, prices in [0, 100),
    any other attribute (a string's code lane) in 0..3 (0 = null), then
    a TIMER block (T = 1) past each block and one far past the end."""
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, parts, n).astype(np.int64)
    cols = {}
    for a in attr_names:
        if a == "kind":
            cols[a] = rng.integers(0, 3, n).astype(np.float32)
        elif a == "price":
            cols[a] = rng.uniform(0, 100, n).astype(np.float32)
        else:
            cols[a] = rng.integers(0, 4, n).astype(np.float32)
    ts = 1_000_000 + np.cumsum(rng.integers(0, 700, n)).astype(np.int64)
    out = []
    for ix in np.array_split(np.arange(n), n_blocks):
        out.append(pack_blocks(pids[ix], {a: c[ix] for a, c in cols.items()},
                               ts[ix], np.zeros(len(ix), np.int32), parts,
                               base_ts=1_000_000))
        out.append(jax_timer_block(parts, int(ts[ix[-1]]) - 1_000_000 +
                                   1_700, attr_names))
    out.append(jax_timer_block(parts, 10 ** 7, attr_names))
    return out


def _pair(name, B=None, parts=8, K=4):
    tel = name in TELEMETRY
    ref = JaxNFA(CLASS[name], n_partitions=parts, n_slots=K, mesh=None,
                 batch_b=B, telemetry=tel)
    nfa = CompiledPatternNFA(CLASS[name], n_partitions=parts, n_slots=K,
                             batch_b=B, telemetry=tel, device="cpu")
    return ref, nfa


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("name", sorted(CLASS))
def test_class_step_equals_jax_and_kernel_model(name, B):
    """JAX build_block_step == the plain step == the kernel model, every
    carry leaf and output, over chained blocks and TIMER blocks."""
    ref, nfa = _pair(name, B)
    assert nfa.kprog.reason is None, nfa.kprog.reason
    jstep = jax.jit(build_block_step(ref.spec))
    jc = ref.carry
    tc = tm = _torch_carry({k: np.asarray(v) for k, v in jc.items()})
    matches = 0
    for bi, block in enumerate(_blocks(ref.spec.attr_names, 8, seed=23)):
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


@pytest.mark.parametrize("name", sorted(CLASS))
def test_class_kinds_are_in_the_kernels_class(name):
    """Each kind is inside the step's class and runs its widened
    instance; the pattern bank's kernels take each kind too (their
    widened instance)."""
    _ref, nfa = _pair(name)
    assert kernel_class_reason(nfa.spec) is None
    assert nfa.kprog.reason is None, nfa.kprog.reason
    assert kernel_wide(nfa.spec, nfa.kprog)
    assert kernel_flags(nfa.spec, nfa.kprog, 7, 1) & 1
    assert bank_class_reason(nfa.spec, nfa.kprog) is None


def test_widened_program_words_are_what_parse_reads():
    """A Python mirror of csrc's ``parse`` over the widened programs: the
    widened header (each spec field of its name), each unit's kind and
    side B (stream, condition, capture row, `and`), the mid-chain groups
    in ascending start, and the capture-to-constant table (row, lane, op
    and the constant's float32 bits)."""
    for name in CLASS:
        _ref, nfa = _pair(name)
        spec, kp = nfa.spec, nfa.kprog
        h = parse_prog(kernel_prog(spec, kp))
        kinds = {u.kind for u in spec.units}
        assert (h["wide"], h["is_sequence"], h["is_every"],
                h["every_group_end"], h["tail_every_start"], h["eps_start"],
                h["lead_absent"], h["dead_start"], h["telemetry"],
                h["has_logical"]) == \
            (1, int(spec.is_sequence), int(spec.is_every),
             spec.every_group_end, spec.tail_every_start,
             int(spec.eps_start), int(spec.lead_absent),
             int(spec.dead_start), int(spec.telemetry),
             int("logical" in kinds)), name
        for u, w, wb in zip(spec.units, h["units"], h["units_b"]):
            assert w[0] == UNIT_KINDS.index(u.kind), name
            assert wb == (u.stream_b, u.cond_b, u.row_b, int(u.is_and)), name
        assert h["mid"] == sorted(spec.mid_every), name
        want = tuple(tuple((r, ln, op, int(np.float32(c).view(np.int32)))
                           for r, ln, op, c in q) for q in kp.ccmp)
        assert h["ccmp"] == want, name
    # the capture-to-constant compares as the compiler lowers them: e1's
    # price lane > 40 (e1.price > 40.0) and 70 >= e2.price mirrored
    _ref, cc = _pair("capture constant")
    got = [c for q in cc.kprog.ccmp for c in q]
    assert [(CMP_OPS[op], c) for _r, _l, op, c in got] == [(">", 40.0),
                                                            ("<=", 70.0)]
    # the string rewrite's null guard: e1.sym != 0
    _ref, sg = _pair("string guard")
    assert [(CMP_OPS[op], c) for q in sg.kprog.ccmp
            for _r, _l, op, c in q] == [("!=", 0.0)]


#: the boundary since condition programs (plan/nfa_program.py): arithmetic,
#: functions, `or`, `not`, two captures compared and a kleene condition
#: reading its own [last] are inside; these stay out
OUTSIDE = {
    "INT arithmetic around a capture compare": (
        "from every e1=S[kind == 0] -> e2=S[kind > e1.kind + 1] select "
        "e1.price as p insert into Out;", "INT/LONG arithmetic"),
    "a transcendental under or": (
        "from every e1=S[kind == 0] -> e2=S[price > e1.price or "
        "math:sin(price) > 0.5] select e1.price as p insert into Out;",
        "transcendental math:sin"),
    "ifThenElse under not": (
        "from every e1=S[kind == 0] -> e2=S[not (ifThenElse(kind == 1, "
        "price, 0.0) > e1.price)] select e1.price as p insert into Out;",
        "the function ifThenElse"),
    "is null on a capture": (
        "from every e1=S[kind == 0] -> e2=S[kind == 1] -> e3=S[kind == 2 and "
        "(e1.price is null or e1.price < e2.price)] select e1.price as p "
        "insert into Out;", "`is null` outside the [last] rewrite"),
    "a kleene condition reading its own [last] through exp": (
        "from every e1=S[kind == 0] -> e2=S[kind == 1 and math:exp(price) "
        "> e2[last].price]<1:3> -> e3=S[kind == 2] select e1.price as p "
        "insert into Out;", "transcendental math:exp"),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_condition_forms_left_out_keep_their_reason(name):
    text, word = OUTSIDE[name]
    nfa = CompiledPatternNFA(STREAM + text, n_partitions=2, device="cpu")
    assert nfa.kprog.reason is not None and word in nfa.kprog.reason, \
        nfa.kprog.reason


def test_more_than_31_conditions_keeps_its_reason():
    """Bit 31 of the gate word is the event's __valid: a spec of 32
    conditions stays outside the class."""
    chain = " -> ".join(f"e{i}=S[kind == {i % 3}]" for i in range(32))
    nfa = CompiledPatternNFA(STREAM + f"from {chain} select e0.price as p "
                             "insert into Out;", n_partitions=2,
                             device="cpu")
    assert len(nfa.spec.cond_fns) == 32
    assert "31 conditions" in nfa.kprog.reason
    assert MAX_MID_EVERY == 4
