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
- a numpy model of the ring kernel's selection (the ring-th largest count
  by bisection, every lane above it, the lowest-index lanes equal to it,
  ordered by rank) equals the stable descending sort on tie-heavy counts;
- a bank outside the kernel's class is refused on CUDA before any device
  memory is touched, naming the feature;
- ``import siddhi_tpu_torch`` and the bank leave jax out.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from siddhi_tpu_torch.ops.nfa import (CMP_OPS, bank_lanes_plain,  # noqa: E402
                                      bank_ring_plain, kernel_prog,
                                      nfa_bank_step, nfa_bank_step_plain)
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


def test_kernel_program_layout():
    """kernel_prog's table, parsed as csrc/nfa_step.cu parses it, gives
    back the units, both compare tables and the capture sources."""
    bank = _bank("chain3")
    spec, kp = bank.nfa.spec, bank.nfa.kprog
    prog = kernel_prog(spec, kp)
    S, R, C, has_within, within, arm_once, n_cond, n_cmp, n_pcmp = prog[:9]
    assert (S, has_within, within, arm_once) == (3, 1, 9000, 0)
    assert n_cond == len(spec.cond_fns) == len(kp.cmp) == len(kp.pcmp)
    pos = 9
    units = [tuple(prog[pos + 3 * i:pos + 3 * i + 3]) for i in range(S)]
    assert units == [(u.stream_a, u.cond_a, u.row_a) for u in spec.units]
    pos += 3 * S
    assert tuple(prog[pos:pos + R * C]) == kp.row_src
    pos += R * C

    def table(width, n):
        nonlocal pos
        start = prog[pos:pos + n_cond + 1]
        pos += n_cond + 1
        flat = prog[pos:pos + width * n]
        pos += width * n
        return tuple(tuple(tuple(flat[width * q:width * q + width])
                           for q in range(start[i], start[i + 1]))
                     for i in range(n_cond))
    assert table(4, n_cmp) == kp.cmp
    assert table(3, n_pcmp) == kp.pcmp
    assert pos == len(prog)
    # e1: `{a} <= price` mirrored to `price >= {a}`, and `kind != 1`
    assert kp.pcmp[0] == ((kp.kern_attrs.index("price"), 0,
                           CMP_OPS.index(">=")),
                          (kp.kern_attrs.index("kind"), 1,
                           CMP_OPS.index("!=")))


def _ring_model(count: np.ndarray, ring: int) -> np.ndarray:
    """csrc/nfa_step.cu's ring selection for one pattern → ring lanes."""
    P = len(count)
    threads = 256
    lo, hi = int(count.min()), int(count.max()) + 1
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if int((count >= mid).sum()) >= ring:
            lo = mid
        else:
            hi = mid
    v = lo
    run = -(-P // threads)
    need = ring - int((count > v).sum())
    sel = []
    eq_before = 0
    for t in range(threads):           # contiguous lane runs, in order
        i0, i1 = min(P, t * run), min(P, t * run + run)
        seg = count[i0:i1]
        eq = int((seg == v).sum())
        take = min(eq, max(need - eq_before, 0))
        eq_before += eq
        seen = 0
        for i in range(i0, i1):
            if count[i] > v:
                sel.append(i)
            elif count[i] == v:
                if seen < take:
                    sel.append(i)
                seen += 1
    assert len(sel) == ring
    cnt = count[sel]
    rank = [int((cnt > x).sum() + (cnt[:j] == x).sum())
            for j, x in enumerate(cnt)]
    out = np.empty(ring, np.int64)
    out[rank] = sel
    return out


RING_CASES = ["few_values", "all_equal", "all_zero", "ring_is_P", "ring_1",
              "sparse", "wide_P"]


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_selection_model_equals_stable_sort(case):
    rng = np.random.default_rng(RING_CASES.index(case))
    P_, ring = 300, 32
    count = rng.integers(0, 3, P_)
    if case == "all_equal":
        count[:] = 5
    elif case == "all_zero":
        count[:] = 0
    elif case == "ring_is_P":
        ring = P_
    elif case == "ring_1":
        ring = 1
    elif case == "sparse":
        count = (rng.random(P_) < 0.02).astype(np.int64) * \
            rng.integers(1, 4, P_)
    elif case == "wide_P":
        P_ = 10_000
        count = rng.integers(0, 2, P_)
    want = torch.sort(torch.from_numpy(count.astype(np.int32)),
                      descending=True, stable=True).indices[:ring].numpy()
    assert np.array_equal(_ring_model(count, ring), want)


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


OUT_OF_CLASS = {
    "count unit": (STREAM + "from every e1=S[kind == 0 and price > {t}]<2:3>"
                   " -> e2=S[kind == 1 and price > e1[last].price] select "
                   "e2.price as p2 insert into Out;", "kleene count"),
    "arithmetic on a constant": (
        STREAM + "from every e1=S[kind == 0 and price * 2 > {t}] -> "
        "e2=S[kind == 1 and price > e1.price] select e1.price as p1 "
        "insert into Out;", "pattern constant outside"),
}


@pytest.mark.parametrize("name", sorted(OUT_OF_CLASS))
def test_out_of_class_bank_refused_on_cuda(name, monkeypatch):
    """torch.cuda reported available: the refusal comes before any device
    memory is touched (this torch has no CUDA, so an allocation would
    fail otherwise); the CPU bank runs the same apps."""
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
