"""The fused NFA egress of the CUDA kernels, modelled on the CPU.

``csrc/nfa_step.cu`` computes one block step and its match compaction in
two launches: the step writes each matched slot as a scratch row (flat
index, ts, enter, seq, captures, its rank in its lane, its lane in the
CTA) into its CTA's segment, in whatever order the lanes reach the CTA's
counter, and each lane's count and each CTA's true fill; the compaction
sums the fills before each CTA, scans its lanes' counts and scatters each
row to ``slab[offset(p) + rank]`` below cap, then writes -1 into column 0
of the rows past the count, the tail row and the status row.

``kernel_model`` below is that decomposition in numpy, fed the plain
step's dense outputs, with the kernel's geometry (``kernel_geometry``)
and a shuffled order inside each segment.  It must equal the plain
composition (``nfa_step_egress`` on the CPU: the plain step, then the
compaction) bit for bit on every in-class shape, with forced segment
overflows and caps below the count.  The engine's overflow paths
(``CompiledPatternNFA.egress_retire``) are driven through the same model.
"""
import numpy as np
import pytest
import torch

from siddhi_tpu_torch.ops.nfa import (NfaEgress, kernel_geometry,
                                      make_timer_block, nfa_block_step_plain,
                                      nfa_step_egress)
from siddhi_tpu_torch.ops.pack import pack_blocks
from siddhi_tpu_torch.plan import nfa_compiler
from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA

from test_torch_nfa_step import IN_CLASS, STREAM  # the kernel's class

#: rare completions: partials pile up past 32 slots in a lane
RARE_CLOSE = (STREAM + "from every e1=S[kind == 0] -> e2=S[kind == 1 and "
              "price > 99.0 and price > e1.price] select e1.price as p1, "
              "e2.price as p2 insert into Out;")

UNWRITTEN = 0x5EED       # slab cells the kernels leave as torch.empty has them


def kernel_model(outs, dropped, K, seg, cap, rng, waiting=None):
    """The two kernels' decomposition in numpy, from the plain step's dense
    outputs ``outs`` (mask, caps, ts, enter, seq) and the new carry's
    ``dropped``: the [cap + 2, 4 + R*C] egress buffer they write.  With
    absent units, ``waiting`` is the new carry's deadline of each slot
    waiting at one ([P, K] int64, 2^31 - 1 elsewhere): the step reduces it
    per CTA, the compaction over the CTAs into the tail's column 2."""
    mask, caps, ts, enter, seq = [np.asarray(o) for o in outs]
    P, T, _ = mask.shape
    RC = caps.shape[-2] * caps.shape[-1]
    W = 4 + RC
    _G, L = kernel_geometry(K)
    n_cta = -(-P // L)

    # the step: per lane, matched slots in (t, k) order with their rank
    p, t, k = np.nonzero(mask)
    lane_count = np.bincount(p, minlength=P)
    starts = np.cumsum(lane_count) - lane_count
    rank = np.arange(len(p)) - starts[p]
    caps_i = caps.view(np.int32).reshape(P, T, K, RC)[p, t, k]
    rows = np.column_stack([
        ((p * T + t) * K + k).astype(np.int32), ts[p, t, k], enter[p, t, k],
        seq[p, t, k], caps_i, rank, p % L]).astype(np.int32)
    cta = p // L
    fill = np.bincount(cta, minlength=n_cta)
    scratch = np.zeros((n_cta, seg, W + 2), np.int32)
    for c in range(n_cta):
        mine = rows[cta == c][rng.permutation(int(fill[c]))]
        scratch[c, :min(seg, len(mine))] = mine[:seg]

    # the compaction: CTA offsets, per-CTA scans of lane counts, scatter
    before = np.cumsum(fill) - fill
    total = int(fill.sum())
    slab = np.full((cap + 2, W), UNWRITTEN, np.int32)
    for c in range(n_cta):
        counts = lane_count[c * L:(c + 1) * L]
        lane_off = np.cumsum(counts) - counts
        for r in scratch[c, :min(int(fill[c]), seg)]:
            dest = before[c] + lane_off[r[W + 1]] + r[W]
            if dest < cap:
                slab[dest] = r[:W]
    slab[total:cap, 0] = -1
    slab[cap] = 0
    slab[cap, :2] = (total, int(np.asarray(dropped).sum()))
    if waiting is not None:
        per_cta = [int(np.asarray(waiting)[c * L:(c + 1) * L].min())
                   for c in range(n_cta)]
        slab[cap, 2] = min(per_cta)
    slab[cap + 1] = 0
    slab[cap + 1, :2] = (int(fill.max()) if n_cta else 0, seg)
    return slab


def assert_slab_equal(got, want, cap, what):
    """The contract: rows up to the count, column 0 of the padding rows,
    the tail row."""
    got, want = np.asarray(got), np.asarray(want)
    count = int(want[cap, 0])
    n = min(count, cap)
    assert np.array_equal(got[:n], want[:n]), f"{what}: matched rows"
    assert np.array_equal(got[n:cap, 0], want[n:cap, 0]), f"{what}: padding"
    assert np.array_equal(got[cap], want[cap]), f"{what}: tail row"


def _blocks(nfa, parts, seed, n_blocks=3, n=3000, gap=20, nan=False,
            timer=True):
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, parts, n).astype(np.int64)
    price = rng.uniform(0, 100, n).astype(np.float32)
    if nan:
        price[rng.random(n) < 0.1] = np.nan
    raw = {"price": price, "kind": rng.integers(0, 3, n),
           "qty": rng.integers(0, 6, n), "partition": pids}
    cols = {a: (nfa.int_exact_lane(a, raw[nfa.int_exact_src[a]])
                if a in nfa.int_exact_src else raw[a].astype(np.float32))
            for a in nfa.attr_names}
    ts = 1_000_000 + np.cumsum(rng.integers(0, gap, n)).astype(np.int64)
    codes = rng.integers(0, len(nfa.stream_codes), n).astype(np.int32)
    out = [pack_blocks(pids[ix], {a: c[ix] for a, c in cols.items()},
                       ts[ix], codes[ix], parts, base_ts=1_000_000)
           for ix in np.array_split(np.arange(n), n_blocks)]
    if timer:
        out.append(make_timer_block(parts, int(ts[-1] - 1_000_000) + 60_000,
                                    nfa.attr_names))
    return [{k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in b.items()} for b in out]


def _bits(t):
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _waiting(spec, carry):
    """Each slot's deadline where it waits at an absent unit, 2^31 - 1
    elsewhere; None for a spec without absent units."""
    if "deadline" not in carry:
        return None
    absent = np.array([u.kind == "absent" for u in spec.units] + [False])
    st = carry["slot_state"].numpy()
    at = absent[np.clip(st, 0, len(spec.units))] & (st >= 0)
    return np.where(at, carry["deadline"].numpy().astype(np.int64),
                    2 ** 31 - 1)


def _run(app, K, parts, seed, nan=False, seg=None, gap=20):
    """Chained blocks through the plain composition and the model; returns
    (matches, dropped, most live in a lane, segment overflows seen)."""
    nfa = CompiledPatternNFA(app, n_partitions=parts, n_slots=K,
                             device="cpu")
    assert nfa.kprog.reason is None, nfa.kprog.reason
    rng = np.random.default_rng(seed + 100)
    carry = nfa.carry
    matches = most = overflows = 0
    for bi, block in enumerate(_blocks(nfa, parts, seed, nan=nan, gap=gap)):
        new, outs = nfa_block_step_plain(nfa.spec, carry, block)
        comp, eg = nfa_step_egress(nfa.spec, carry, block, nfa.kprog, cap=3)
        for key in new:
            assert np.array_equal(_bits(comp[key]), _bits(new[key])), key
        count = int(eg.buf[-2, 0])
        _G, L = kernel_geometry(K)
        s = seg if seg is not None else 4 * L
        for cap in (3, count + 5):
            want = eg.buf if cap == 3 else eg.repack(cap)
            waiting = _waiting(nfa.spec, new)
            got = kernel_model(outs, new["dropped"], K, s, cap, rng, waiting)
            if got[-1, 0] > got[-1, 1]:
                # a full segment lost rows: the engine re-runs the step
                # with segments that fit (next power of two)
                overflows += 1
                s2 = 1 << (int(got[-1, 0]) - 1).bit_length()
                got = kernel_model(outs, new["dropped"], K, s2, cap, rng,
                                   waiting)
            assert_slab_equal(got, want, cap, f"block {bi} cap {cap}")
        matches += count
        most = max(most, int((new["slot_state"] >= 0).sum(dim=1).max()))
        carry = new
    return matches, int(carry["dropped"].sum()), most, overflows


@pytest.mark.parametrize("feed", ["uniform", "nan"])
@pytest.mark.parametrize("name", sorted(IN_CLASS))
def test_kernel_decomposition_equals_plain(name, feed):
    """Every in-class shape, chained blocks and a TIMER block, 200 lanes
    (four CTAs at K = 4), caps below and above the count."""
    matches, _d, _m, _o = _run(IN_CLASS[name], K=4, parts=200, seed=21,
                               nan=feed == "nan")
    assert matches > 3, f"{name}: too few matches"


@pytest.mark.parametrize("case", ["segment_overflow", "K1_drops", "K40"])
def test_kernel_decomposition_edge_cases(case):
    if case == "segment_overflow":
        # one scratch row per CTA: every busy CTA overflows, and the
        # re-run's segments hold the rows
        matches, _d, _m, overflows = _run(IN_CLASS["partitioned_app"], K=8,
                                          parts=300, seed=5, seg=1)
        assert overflows > 0 and matches > 3
    elif case == "K1_drops":
        # one slot and a long `within`: arming finds no free slot
        matches, dropped, _m, _o = _run(IN_CLASS["partitioned_app"], K=1,
                                        parts=300, seed=6)
        assert dropped > 0 and matches > 0
    else:
        # rare completions, no `within`: more than 32 live partials in a
        # lane, so a thread of the 32-wide group owns two slots
        matches, _d, most, _o = _run(RARE_CLOSE, K=40, parts=12, seed=7,
                                     gap=10)
        assert most > 32 and matches > 0


@pytest.mark.parametrize("K,G,L", [(1, 1, 256), (2, 2, 128), (3, 4, 64),
                                   (8, 8, 32), (9, 16, 16), (32, 32, 8),
                                   (40, 32, 8), (1000, 32, 8)])
def test_kernel_geometry(K, G, L):
    assert kernel_geometry(K) == (G, L)


def _model_step(calls):
    """A stand-in for nfa_step_egress that runs the plain step and then
    the kernel model: scratch segments of ``seg`` rows (1 unless the
    engine asks for more), so the engine's overflow paths run on the
    CPU."""
    rng = np.random.default_rng(0)

    def step(spec, carry, block, kprog, cap, seg, batch_b):
        new, outs = nfa_block_step_plain(spec, carry, block, batch_b)
        s = 1 if seg is None else seg
        calls.append(s)

        def repack(c):
            return torch.from_numpy(kernel_model(
                outs, new["dropped"], spec.n_slots, s, c, rng,
                _waiting(spec, new)))
        return new, NfaEgress(repack(cap), repack, s)
    return step


def test_engine_resolves_segment_and_cap_overflow(monkeypatch):
    """egress_retire reads both overflows from the egress buffer: a full
    segment re-runs the step from the handle's carry and block with
    segments that fit, a count above cap re-runs the compaction alone;
    the decoded rows equal the plain engine's, in order."""
    app = IN_CLASS["partitioned_app"]
    rng = np.random.default_rng(9)
    n = 3000
    feeds = [(rng.integers(0, 300, n),
              {"partition": rng.integers(0, 300, n).astype(np.float32),
               "price": rng.uniform(0, 100, n).astype(np.float32),
               "kind": rng.integers(0, 2, n).astype(np.float32)},
              1_000_000 + c * n * 3 + np.arange(n, dtype=np.int64) * 3)
             for c in range(3)]

    def run():
        nfa = CompiledPatternNFA(app, n_partitions=300, n_slots=8,
                                 device="cpu")
        nfa._egress_cap = 2
        out = []
        for pids, cols, ts in feeds:
            out += nfa.process_events(pids, cols, ts)
        out += nfa.process_timer(int(feeds[-1][2][-1]) + 60_000)
        return nfa, out

    _plain, want = run()
    calls = []
    monkeypatch.setattr(nfa_compiler, "nfa_step_egress", _model_step(calls))
    nfa, got = run()
    assert len(want) > 100
    assert got == want
    assert 1 in calls and nfa._egress_seg > 1, calls    # re-ran the step
    assert nfa._egress_cap > 2                          # re-ran the compaction
