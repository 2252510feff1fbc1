"""The torch port's NFA block step vs the JAX package's.

For each pattern family of ``tests/test_nfa_batch.py``'s SHAPES (copied
here) and B in {1, 4}, the same numpy blocks (made from a seed) go through
``jax.jit(build_block_step(spec))`` on the CPU and through the port's
``nfa_block_step_plain``, chained over three blocks.  Every carry leaf and
every output (mask, caps, ts, enter, seq) must be BIT-identical: both
compute the same float32/int32 operations in the same order (compares,
selects and copies; the only arithmetic is int32 timestamp offsets).

Also: the TIMER block, and the plain composition's egress slab (the
step, then the compaction) on every in-class shape, equal the JAX
package's; the CPU model of the CUDA kernel's inputs (a block-wide gate
word plus a compare table, applied by the plain loop) equals the plain
step on every in-class shape (kleene counts and absent units among
them; tests/test_torch_nfa_widened.py holds more of both against JAX);
the kernel-class predicate rejects each out-of-class family, and on a
CUDA device the compiler refuses them.
"""
import jax
import numpy as np
import pytest
import torch

from siddhi_tpu.ops.nfa import build_block_step
from siddhi_tpu.ops.nfa import make_timer_block as jax_timer_block
from siddhi_tpu.plan.nfa_compiler import CompiledPatternNFA as JaxNFA
from siddhi_tpu_torch.ops.nfa import (_structural_wide, bank_class_reason,
                                      kernel_wide, make_timer_block,
                                      nfa_block_step_plain, nfa_step_egress)
from siddhi_tpu_torch.ops.pack import pack_blocks
from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
from siddhi_tpu_torch.utils.errors import SiddhiAppCreationError

STREAM = "define stream S (price float, kind int);\n"

#: the parity grid of tests/test_nfa_batch.py — one app per family
SHAPES = {
    "every_within":
        "from every e1=S[kind == 0] -> "
        "e2=S[kind == 1 and price > e1.price] within 3 sec "
        "select e1.price as p1, e2.price as p2 insert into Out;",
    "count":
        "from every e1=S[kind == 0] -> "
        "e2=S[kind == 1 and not (price < e2[last].price)]<1:3> -> "
        "e3=S[kind == 0] "
        "select e1.price as p1, e3.price as p3 insert into Out;",
    "kleene0_within":
        "from e1=S[kind == 0] -> e2=S[kind == 2]<0:3> -> "
        "e3=S[kind == 1] within 4 sec "
        "select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into Out;",
    "absent":
        "from every e1=S[kind == 0 and price > 60.0] -> "
        "not S[kind == 1 and price > e1.price] for 2 sec "
        "select e1.price as p1 insert into Out;",
    "sequence":
        "from every e1=S[kind == 0], e2=S[kind == 1] "
        "select e1.price as p1, e2.price as p2 insert into Out;",
}

#: specs inside the CUDA kernel's class (beyond SHAPES' every_within)
IN_CLASS = {
    "every_within": STREAM + SHAPES["every_within"],
    "partitioned_app":
        "define stream S (partition int, price float, kind int);\n"
        "from every e1=S[kind == 0 and price > 50.0] -> "
        "e2=S[kind == 1 and price > e1.price] within 10 sec "
        "select e1.price as p1, e2.price as p2 insert into Out;",
    "chain3":
        STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and "
        "e1.price < price] -> e3=S[kind == 2 and price <= e2.price and "
        "price != e1.price] within 5 sec select e1.price as p1, "
        "e2.price as p2, e3.price as p3 insert into Out;",
    "no_every":
        STREAM + "from e1=S[kind == 0] -> e2=S[kind == 1 and price >= "
        "e1.price] select e1.price as p1, e2.price as p2 insert into Out;",
    "two_streams":
        "define stream A (price float, kind int);\n"
        "define stream B (price float, qty int);\n"
        "from every e1=A[price > 20.0] -> e2=B[price < e1.price and "
        "qty > 1] within 2 sec select e1.price as p1, e2.qty as q "
        "insert into Out;",
    "no_within":
        STREAM + "from every e1=S[kind == 0] -> e2=S[price > e1.price] "
        "select e1.kind as k, e2.price as p2 insert into Out;",
    "one_unit":
        STREAM + "from every e1=S[price > 90.0] select e1.price as p "
        "insert into Out;",
    # kleene counts: mid-chain against the first unit's capture, with a
    # later unit reading its [last] bank; a min-0 count after a unit
    "count":
        STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and price > "
        "e1.price]<1:3> -> e3=S[kind == 0 and price < e2[last].price] "
        "within 4 sec select e1.price as p1, e2[0].price as f2, "
        "e2[last].price as l2, e3.price as p3 insert into Out;",
    "kleene0_within": STREAM + SHAPES["kleene0_within"],
    # absent units: trailing, against the first unit's capture
    "absent": STREAM + SHAPES["absent"],
}

#: out-of-class families and a word of the reason each must give: a
#: kleene count whose own condition reads its [last] bank (the empty-chain
#: guard), a leading min-0 count, a leading absent unit, SEQUENCE (with an
#: absent unit too), ...
OUT_OF_CLASS = {
    "count": (STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and "
              "not (math:log(price) < e2[last].price)]<1:3> -> e3=S[kind "
              "== 0] select e1.price as p1, e3.price as p3 insert into "
              "Out;", "transcendental"),
    "kleene0":
        (STREAM + "from e2=S[kind == 2]<0:3> -> e3=S[kind == 1] within 4 "
         "sec select e2.price as p2, e3.price as p3 insert into Out;",
         "kleene"),
    "absent":
        (STREAM + "from not S[kind == 1] for 2 sec -> e2=S[kind == 0] "
         "select e2.price as p2 insert into Out;", "absent"),
    "sequence": (STREAM + SHAPES["sequence"], "SEQUENCE"),
    "sequence_absent":
        (STREAM + "from every e1=S[kind == 0], not S[kind == 1] for 2 sec "
         "select e1.price as p1 insert into Out;", "SEQUENCE"),
    "logical":
        (STREAM + "from every e1=S[kind == 0] -> (e2=S[kind == 1] and "
         "e3=S[kind == 2]) select e1.price as p insert into Out;",
         "logical"),
    "every_group":
        (STREAM + "from every (e1=S[kind == 0] -> e2=S[kind == 1]) -> "
         "e3=S[kind == 2] select e1.price as p insert into Out;",
         "`every` group"),
    "mid_every":
        (STREAM + "from e1=S[kind == 0] -> every e2=S[kind == 1] -> "
         "e3=S[kind == 2] select e1.price as p insert into Out;",
         "mid-chain"),
    "tail_every":
        (STREAM + "from e1=S[kind == 0] -> every e2=S[kind == 1] "
         "select e1.price as p insert into Out;", "trailing"),
    "arithmetic":
        (STREAM + "from every e1=S[kind == 0] -> e2=S[kind > "
         "e1.kind + 1] select e1.price as p insert into Out;",
         "INT/LONG arithmetic"),
    "or_capture":
        (STREAM + "from every e1=S[kind == 0] -> e2=S[price > e1.price "
         "or math:exp(price) > 2.0] select e1.price as p insert into Out;",
         "transcendental"),
}


def _feed(n=220, seed=0, parts=2, streams=1, nan=False):
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, parts, n).astype(np.int64)
    price = rng.uniform(0, 100, n).astype(np.float32)
    if nan:
        price[rng.random(n) < 0.1] = np.nan
    cols = {"price": price,
            "kind": rng.integers(0, 3, n).astype(np.float32),
            "qty": rng.integers(0, 6, n).astype(np.float32),
            "partition": pids.astype(np.float32)}
    ts = 1_000_000 + np.cumsum(rng.integers(0, 900, n)).astype(np.int64)
    codes = rng.integers(0, streams, n).astype(np.int32)
    return pids, cols, ts, codes


def _blocks(attr_names, parts, seed, n_blocks=3, streams=1, n=220,
            nfa=None, nan=False):
    """Chained [P, T] blocks of one feed; ``nfa`` (a port compiler)
    derives the exact-integer companion lanes of selected INT attrs."""
    pids, cols, ts, codes = _feed(n=n, seed=seed, parts=parts,
                                  streams=streams, nan=nan)
    cols = {a: (nfa.int_exact_lane(a, cols[nfa.int_exact_src[a]]
                                   .astype(np.int64))
                if nfa is not None and a in nfa.int_exact_src else cols[a])
            for a in attr_names}
    out = []
    for ix in np.array_split(np.arange(n), n_blocks):
        out.append(pack_blocks(pids[ix], {a: c[ix] for a, c in cols.items()},
                               ts[ix], codes[ix], parts,
                               base_ts=1_000_000))
    return out


def _bits(a):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(name, got, want):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, \
        f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}"
    assert np.array_equal(g, w), \
        f"{name}: {int((g != w).sum())} elements differ"


def _torch_block(block):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in block.items()}


def _torch_carry(carry):
    return {k: torch.from_numpy(np.array(v)) for k, v in carry.items()}


OUT_NAMES = ("mask", "caps", "ts", "enter", "seq")


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_step_bit_identical_to_jax(shape, B):
    app = STREAM + SHAPES[shape]
    parts = 3
    ref = JaxNFA(app, n_partitions=parts, n_slots=4, mesh=None, batch_b=B)
    nfa = CompiledPatternNFA(app, n_partitions=parts, n_slots=4,
                             batch_b=B, device="cpu")
    assert nfa.spec.attr_names == ref.spec.attr_names
    jstep = jax.jit(build_block_step(ref.spec))
    jc = ref.carry
    tc = _torch_carry({k: np.asarray(v) for k, v in jc.items()})
    matches = 0
    blocks = _blocks(ref.spec.attr_names, parts, seed=7)
    if shape == "absent":
        # TIMER rows drive the deadlines between real events
        blocks.append(make_timer_block(parts, 400_000, ref.spec.attr_names))
    for bi, block in enumerate(blocks):
        jc, jy = jstep(jc, block)
        tc, ty = nfa_block_step_plain(nfa.spec, tc, _torch_block(block))
        assert sorted(tc) == sorted(jc)
        for k in jc:
            _same(f"{shape} B={B} block {bi} carry.{k}", tc[k], jc[k])
        for name, g, w in zip(OUT_NAMES, ty, jy):
            _same(f"{shape} B={B} block {bi} {name}", g, w)
        matches += int(np.asarray(jy[0]).sum())
    assert matches > 0, f"{shape}: degenerate cell (0 matches)"


def test_timer_block_equals_jax():
    names = ("price", "kind")
    got = make_timer_block(5, 123_456, names)
    want = jax_timer_block(5, 123_456, names)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


#: apps whose egress slab is held against the JAX package's
EGRESS_APPS = {"every_within": STREAM + SHAPES["every_within"],
               "absent": STREAM + SHAPES["absent"],
               **{k: v for k, v in IN_CLASS.items() if k != "every_within"}}


@pytest.mark.parametrize("shape", sorted(EGRESS_APPS))
def test_egress_pack_rows_equal_jax(shape):
    """The plain composition (nfa_step_egress on the CPU: the plain step,
    then the compaction) against the JAX package's build_block_step then
    _egress_pack_fn, over chained blocks: the same [cap+1, 4+R*C] int32
    slab (matched slots in flat order, tail row) at a cap below the count
    and above it, and the same carry."""
    app = EGRESS_APPS[shape]
    ref = JaxNFA(app, n_partitions=3, n_slots=4, mesh=None)
    nfa = CompiledPatternNFA(app, n_partitions=3, n_slots=4, device="cpu")
    jstep = jax.jit(build_block_step(ref.spec))
    jc = ref.carry
    tc = _torch_carry({k: np.asarray(v) for k, v in jc.items()})
    blocks = _blocks(ref.spec.attr_names, 3, seed=3, streams=len(
        nfa.stream_codes), nfa=nfa)
    if ref.has_absent:
        blocks.append(jax_timer_block(3, 400_000, ref.spec.attr_names))
    most = 0
    for bi, block in enumerate(blocks):
        jc, jy = jstep(jc, block)
        jcn = {k: np.array(v) for k, v in jc.items()}
        tc, eg = nfa_step_egress(nfa.spec, tc, _torch_block(block),
                                 nfa.kprog, cap=1)
        for k in jcn:
            _same(f"{shape} block {bi} carry.{k}", tc[k], jcn[k])
        dl_st = jcn["slot_state"] if ref.has_absent else None
        dl = jcn.get("deadline") if ref.has_absent else None
        for cap in (1, 1024):
            want = np.asarray(ref._egress_pack_fn()(
                *[np.asarray(y) for y in jy], jcn["dropped"], dl_st, dl, cap))
            if not ref.has_absent:
                want = want.copy()
                want[-1, 2] = 0
            got = eg.buf if cap == 1 else eg.repack(cap)
            assert not got[-1].any()        # no segments on the plain path
            _same(f"{shape} block {bi} cap={cap} egress rows", got[:-1],
                  want)
        most = max(most, int(want[-1, 0]))
    assert most > 1, f"{shape}: no block's count passes the cap"


@pytest.mark.parametrize("feed", ["uniform", "nan"])
@pytest.mark.parametrize("name", sorted(IN_CLASS))
def test_kernel_model_equals_plain(name, feed):
    """The kernel's inputs — a block-wide gate word plus the compare
    table, applied by the plain loop — give the plain step's carry and
    outputs bit for bit, over chained blocks; with NaN prices too (a NaN
    operand makes < <= > >= == false and != true in both)."""
    nfa = CompiledPatternNFA(IN_CLASS[name], n_partitions=4, n_slots=4,
                             device="cpu")
    kprog = nfa.kprog
    assert kprog.reason is None, kprog.reason
    streams = len(nfa.stream_codes)
    blocks = _blocks(nfa.spec.attr_names, 4, seed=11, streams=streams,
                     n_blocks=4, n=400, nfa=nfa, nan=feed == "nan")
    blocks.append(make_timer_block(4, 600_000, nfa.spec.attr_names))
    cp = cm = nfa.carry
    matches = 0
    for bi, block in enumerate(blocks):
        tb = _torch_block(block)
        cp, yp = nfa_block_step_plain(nfa.spec, cp, tb)
        cm, ym = nfa_block_step_plain(nfa.spec, cm, tb, kprog=kprog)
        for k in cp:
            _same(f"{name} block {bi} carry.{k}", cm[k], cp[k])
        for n_, g, w in zip(OUT_NAMES, ym, yp):
            _same(f"{name} block {bi} {n_}", g, w)
        matches += int(yp[0].sum())
    assert matches > 0, f"{name}: degenerate cell (0 matches)"


def test_kernel_model_forces_drops():
    """K = 1 with a long `within`: arming finds no free slot, `dropped`
    counts, and model and plain still agree."""
    nfa = CompiledPatternNFA(IN_CLASS["partitioned_app"], n_partitions=4,
                             n_slots=1, device="cpu")
    blocks = _blocks(nfa.spec.attr_names, 4, seed=5, n=300)
    cp = cm = nfa.carry
    for block in blocks:
        tb = _torch_block(block)
        cp, yp = nfa_block_step_plain(nfa.spec, cp, tb)
        cm, ym = nfa_block_step_plain(nfa.spec, cm, tb, kprog=nfa.kprog)
        for k in cp:
            _same(f"carry.{k}", cm[k], cp[k])
        for n_, g, w in zip(OUT_NAMES, ym, yp):
            _same(n_, g, w)
    assert int(cp["dropped"].sum()) > 0


def test_plain_step_keeps_input_carry():
    """Functional carry: grow-and-replay re-runs a chunk from it."""
    nfa = CompiledPatternNFA(IN_CLASS["every_within"], n_partitions=3,
                             n_slots=4, device="cpu")
    block = _torch_block(_blocks(nfa.spec.attr_names, 3, seed=2,
                                 n_blocks=1)[0])
    before = {k: v.clone() for k, v in nfa.carry.items()}
    new, _ = nfa_step_egress(nfa.spec, nfa.carry, block, nfa.kprog)
    for k, v in before.items():
        assert torch.equal(nfa.carry[k], v), k
    assert not torch.equal(new["arm_seq"], before["arm_seq"])


#: OUT_OF_CLASS shapes the step's widened instance takes (the pattern
#: bank's kernels, K3, refused them before their widened instance): both
#: take them now; the rest stay outside both
BANK_ONLY = {"kleene0", "absent", "sequence", "sequence_absent", "logical",
             "every_group", "mid_every", "tail_every"}


@pytest.mark.parametrize("name", sorted(OUT_OF_CLASS))
def test_class_predicate_rejects(name, monkeypatch):
    text, word = OUT_OF_CLASS[name]
    nfa = CompiledPatternNFA(text, n_partitions=2, device="cpu")
    if name in BANK_ONLY:
        # inside the step's class and the bank's: the widened instances
        assert nfa.kprog.reason is None, nfa.kprog.reason
        assert bank_class_reason(nfa.spec, nfa.kprog) is None
        assert kernel_wide(nfa.spec, nfa.kprog)
        assert word in _structural_wide(nfa.spec)
        return
    assert nfa.kprog.reason is not None and word in nfa.kprog.reason, \
        nfa.kprog.reason
    # on a CUDA device the same spec is refused while the engine is built,
    # before any device memory is touched
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SiddhiAppCreationError,
                       match="not yet ported to the CUDA NFA kernel"):
        CompiledPatternNFA(text, n_partitions=2, device="cuda")


def test_cuda_wrapper_refuses_out_of_class_spec():
    nfa = CompiledPatternNFA(OUT_OF_CLASS["count"][0], n_partitions=2,
                             device="cpu")
    block = _torch_block(_blocks(nfa.spec.attr_names, 2, seed=1,
                                 n_blocks=1)[0])
    block["__ts"] = block["__ts"].to("meta")
    with pytest.raises(RuntimeError, match="outside the CUDA kernel's class"):
        nfa_step_egress(nfa.spec, nfa.carry, block, nfa.kprog)
