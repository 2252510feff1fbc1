"""The torch port's length-window step vs the JAX package's two versions.

``wagg_step_plain`` (what the CUDA kernel is held against on the card)
is compared with ``jax.jit(build_wagg_step(W, minmax))`` — the jnp scan
the JAX package runs on its public path — and with
``build_wagg_step_pallas`` run in Pallas interpret mode, on the same
numpy inputs, over three chained blocks.  Outputs and all five carry
leaves must be EXACTLY equal: both sides run the same float32 operations
in the same order (IEEE add/sub, exact min/max), and the evicted value
of a finite ring is the same whether read from its slot or summed with a
one-hot mask.
"""
import jax
import numpy as np
import pytest
import torch

from siddhi_tpu.ops.windowed_agg import (build_wagg_step,
                                         build_wagg_step_pallas,
                                         make_wagg_carry as jax_carry)
from siddhi_tpu_torch.ops.windowed_agg import (WaggCarry, kernel_device,
                                               make_wagg_carry, wagg_step,
                                               wagg_step_plain)
from siddhi_tpu_torch.plan.wagg_compiler import carry_from_reference

P = 256
DENSITIES = (0.0, 0.7, 1.0)


def _pallas_step(W, T, minmax):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    step = jax.jit(build_wagg_step_pallas(W, T, want_minmax=minmax))

    def run(carry, values, accepted):
        # the patch matters while the first call traces
        pl.pallas_call = patched
        try:
            return step(carry, values, accepted)
        finally:
            pl.pallas_call = orig
    return run


def _equal(a, b) -> bool:
    """Exact equality, NaN where both are NaN (−0 == +0)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    same = a == b
    if a.dtype.kind == "f":
        same |= np.isnan(a) & np.isnan(b)
    return bool(same.all())


def _torch_run(blocks, W, minmax):
    carry = make_wagg_carry(P, W, device="cpu")
    outs = []
    for v, a in blocks:
        carry, o = wagg_step_plain(carry, torch.from_numpy(v),
                                   torch.from_numpy(a), minmax)
        outs.append([x.numpy() for x in o])
    return carry, outs


def _jax_run(step, blocks, W):
    carry = jax_carry(P, W)
    outs = []
    for v, a in blocks:
        carry, o = step(carry, v, a)
        outs.append([np.asarray(x) for x in o])
    return carry, outs


def _blocks(seed, W, T, density, lo=0.0, hi=10.0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(lo, hi, (P, T)).astype(np.float32),
             rng.random((P, T)) < density) for _ in range(3)]


def _assert_same(c_t, outs_t, c_j, outs_j):
    for bt, bj in zip(outs_t, outs_j):
        assert len(bt) == len(bj)
        for x, y in zip(bt, bj):
            assert x.dtype == y.dtype
            assert _equal(x, y)
    for name, x, y in zip(WaggCarry._fields, c_t, c_j):
        assert _equal(x.numpy(), y), name


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("W", [1, 7, 16])
def test_plain_equals_jnp_scan(W, T, minmax):
    step = jax.jit(build_wagg_step(W, minmax))
    for i, d in enumerate(DENSITIES):
        blocks = _blocks(100 * W + 10 * T + i, W, T, d)
        c_t, o_t = _torch_run(blocks, W, minmax)
        c_j, o_j = _jax_run(step, blocks, W)
        _assert_same(c_t, o_t, c_j, o_j)


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("W", [1, 7, 16])
def test_plain_equals_pallas_interpret(W, T, minmax):
    step = _pallas_step(W, T, minmax)
    for i, d in enumerate(DENSITIES):
        blocks = _blocks(200 * W + 10 * T + i, W, T, d)
        c_t, o_t = _torch_run(blocks, W, minmax)
        c_j, o_j = _jax_run(step, blocks, W)
        _assert_same(c_t, o_t, c_j, o_j)


@pytest.mark.parametrize("minmax", [False, True])
def test_inf_feed_follows_pallas(minmax):
    """±inf values: the port reads the evicted slot, as the Pallas kernel
    does, and agrees with it exactly (NaN where it is NaN).  The jnp scan
    computes the evicted value as sum(ring * onehot), NaN as soon as any
    live slot is ±inf; that intermediate never reaches an output, because
    appending ±inf already turns the Kahan term NaN ((inf - r) - inf), so
    the running sum is NaN from the next accepted event in all three
    versions.  The jnp scan is pinned equal too."""
    W, T = 4, 8
    rng = np.random.default_rng(7)
    blocks = []
    for _ in range(3):
        v = rng.uniform(0, 10, (P, T)).astype(np.float32)
        v[rng.random((P, T)) < 0.1] = np.inf
        v[rng.random((P, T)) < 0.05] = -np.inf
        blocks.append((v, rng.random((P, T)) < 0.8))
    c_t, o_t = _torch_run(blocks, W, minmax)
    c_p, o_p = _jax_run(_pallas_step(W, T, minmax), blocks, W)
    _assert_same(c_t, o_t, c_p, o_p)
    assert np.isnan(o_t[-1][0]).any() and np.isinf(o_t[-1][0]).any()
    c_j, o_j = _jax_run(jax.jit(build_wagg_step(W, minmax)), blocks, W)
    _assert_same(c_t, o_t, c_j, o_j)


def test_step_is_functional_on_cpu():
    """The CPU path runs the plain version and leaves the input carry
    alone (only the CUDA kernel updates in place); it never counts a
    kernel launch."""
    carry = make_wagg_carry(8, 3, device="cpu")
    before = wagg_step.launches
    v = torch.ones((8, 4))
    a = torch.ones((8, 4), dtype=torch.bool)
    new, (s, n) = wagg_step(carry, v, a)
    assert wagg_step.launches == before
    assert float(carry.runsum.sum()) == 0.0
    assert s[:, -1].tolist() == [3.0] * 8 and n[:, -1].tolist() == [3] * 8
    assert new.cnt.dtype == torch.int32 and new.pos.dtype == torch.int32


def test_step_raises_on_unsupported_device():
    carry = make_wagg_carry(2, 3, device="meta")
    v = torch.empty((2, 4), device="meta")
    a = torch.empty((2, 4), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError):
        wagg_step(carry, v, a)


def test_helpers_default_to_the_card():
    """make_wagg_carry and carry_from_reference place their carry on the
    card unless told otherwise; without CUDA that raises kernel_device's
    RuntimeError (the device engine's) rather than building a CPU
    carry."""
    if torch.cuda.is_available():
        pytest.skip("the default is only an error without CUDA")
    with pytest.raises(RuntimeError) as want:
        kernel_device(None)
    with pytest.raises(RuntimeError) as got:
        make_wagg_carry(4, 3)
    assert str(got.value) == str(want.value)
    assert "torch.cuda.is_available() is False" in str(got.value)
    state = {"window_kind": "length",
             "carry": [np.asarray(x) for x in
                       make_wagg_carry(4, 3, device="cpu")]}
    with pytest.raises(RuntimeError) as got:
        carry_from_reference(state)
    assert str(got.value) == str(want.value)
    assert carry_from_reference(state, "cpu").ring.device.type == "cpu"


def test_carry_from_reference_checks_the_fill_invariant():
    """A ring that is not full fills from slot 0, so pos == cnt in such a
    lane; the kernel's min/max path reads the live slots as [0, cnt) and
    would give wrong extrema on a state that breaks it, so the state is
    refused.  A full ring may have any pos; the JAX package's own state
    is accepted as it is."""
    W = 5
    carry = make_wagg_carry(3, W, device="cpu")
    carry, _ = wagg_step_plain(
        carry, torch.arange(21, dtype=torch.float32).reshape(3, 7),
        torch.tensor([[1] * 7, [1, 1, 0, 0, 0, 0, 0], [0] * 7],
                     dtype=torch.bool), True)
    state = {"window_kind": "length",
             "carry": [x.numpy().copy() for x in carry]}
    assert state["carry"][1].tolist() == [2, 2, 0]       # pos
    assert state["carry"][2].tolist() == [W, 2, 0]       # cnt
    got = carry_from_reference(state, "cpu")
    for x, y in zip(got, carry):
        assert _equal(x.numpy(), y.numpy())
    jax_state = {"window_kind": "length",
                 "carry": [np.asarray(x) for x in jax_carry(3, W)]}
    assert carry_from_reference(jax_state, "cpu").cnt.tolist() == [0, 0, 0]
    state["carry"][1][1] = 4                             # cnt 2 < W
    with pytest.raises(ValueError, match="lane 1 has cnt 2 < W 5 but pos 4"):
        carry_from_reference(state, "cpu")


# --------------------------------------------------------------------------
# A numpy model of csrc/wagg_length.cu's decomposition.  CUDA cannot run
# here, so the kernel's index arithmetic is rehearsed on the CPU: the same
# phases, arrays and ranges, one lane at a time, with the extremum scans cut
# into per-thread chunks combined by an exclusive scan as the CTA does
# (MODEL_THREADS threads in place of 256).

MODEL_THREADS = 8
_ID = (0, np.inf, -np.inf)


def _nan_min(a, b):
    return a if a != a else (b if b != b else min(a, b))


def _nan_max(a, b):
    return a if a != a else (b if b != b else max(a, b))


def _combine(a, b):
    if b[0]:
        return b
    return (a[0], _nan_min(a[1], b[1]), _nan_max(a[2], b[2]))


def _block_scan(S, lo, hi, W, fwd, keep_lo, keep_hi):
    """block_scan(): block-segmented prefix/suffix min and max of
    S[lo:hi], kept for [keep_lo, keep_hi)."""
    out_mn = np.full(max(keep_hi - keep_lo, 0), np.nan, np.float32)
    out_mx = out_mn.copy()
    n = max(hi - lo, 0)
    per = -(-n // MODEL_THREADS)
    chunks = [(min(n, th * per), min(n, min(n, th * per) + per))
              for th in range(MODEL_THREADS)]

    def index(r):
        return lo + r if fwd else hi - 1 - r

    def head(i):
        return i % W == 0 if fwd else ((i + 1) % W == 0 or i == hi - 1)

    aggs = []
    for r0, r1 in chunks:
        agg = _ID
        for r in range(r0, r1):
            i = index(r)
            x = float(S[i])
            agg = (1, x, x) if head(i) else _combine(agg, (0, x, x))
        aggs.append(agg)
    carry = _ID
    for (r0, r1), agg in zip(chunks, aggs):
        mn, mx = carry[1], carry[2]
        carry = _combine(carry, agg)
        for r in range(r0, r1):
            i = index(r)
            x = float(S[i])
            if head(i):
                mn = mx = x
            else:
                mn, mx = _nan_min(mn, x), _nan_max(mx, x)
            if keep_lo <= i < keep_hi:
                out_mn[i - keep_lo] = mn
                out_mx[i - keep_lo] = mx
    return out_mn, out_mx


@np.errstate(invalid="ignore")
def _model_lane(ring, pos0, c0, runsum0, comp0, values, ok, W, minmax):
    """One lane of wagg_lane_kernel; ``ring`` is updated in place.  The
    chain and the scans run one after the other here; on the card they
    overlap (warp 0 and the other warps), which changes no value.
    Returns (pos, cnt, runsum, comp, sums, counts, mins, maxs)."""
    T = len(values)
    f32 = np.float32
    # 0. staging (sum path): the entry slots the j-th accepted event may
    # evict, for W - c0 <= j < min(T, W) (NaN elsewhere, so a wrong range
    # shows); the min/max path reads them from S
    ev = np.full(T, np.nan, np.float32)
    j = np.arange(max(0, W - c0), min(T, W))
    ev[j] = ring[(pos0 + j) % W]
    # 1. compaction: per-thread chunks, an exclusive sum of their counts
    per = -(-T // MODEL_THREADS)
    bounds = [(min(T, th * per), min(T, min(T, th * per) + per))
              for th in range(MODEL_THREADS)]
    starts = np.cumsum([0] + [int(ok[t0:t1].sum()) for t0, t1 in bounds])
    a = int(starts[-1])
    kk = np.empty(T, np.int64)
    nv = np.full(a, np.nan, np.float32)
    for (t0, t1), k in zip(bounds, starts):
        for t in range(t0, t1):
            if ok[t]:
                nv[k] = values[t]
                k += 1
            kk[t] = k
    S = None
    if minmax:
        start = pos0 if c0 == W else 0
        slots = start + np.arange(c0)
        S = np.concatenate([ring[np.where(slots < W, slots, slots - W)], nv])
    # 2. evicted values and deltas
    d = np.empty(a, np.float32)
    for j in range(a):
        old = f32(0.0)
        if c0 + j >= W:
            if minmax:
                old = S[c0 + j - W]
            else:
                old = ev[j] if j < W else nv[j - W]
        d[j] = nv[j] - old
    # 3. van Herk / Gil-Werman over S = ring ++ N; a full entry ring is
    # block 0 whole, its extremum the suffix at 0
    full = c0 == W
    L = c0 + a
    pre_lo = W if full else (c0 - 1 if c0 > 0 else 0)
    suf_hi = max(L - W, 0)
    if minmax:
        pre_mn, pre_mx = _block_scan(S, W if full else 0, L, W, True,
                                     pre_lo, L)
        if full or L - W >= 1:
            suf_mn, suf_mx = _block_scan(S, 0, min(L, (suf_hi // W + 1) * W),
                                         W, False, 0, suf_hi + 1)
    # 4. the Kahan chain over accepted events only
    rs, cp = f32(runsum0), f32(comp0)
    for j in range(a):
        y = f32(d[j] - cp)
        t = f32(rs + y)
        cp = f32(f32(t - rs) - y)
        rs = t
        d[j] = rs
    # 5. fill forward
    sums = np.empty(T, np.float32)
    counts = np.empty(T, np.int32)
    mins = np.empty(T, np.float32)
    maxs = np.empty(T, np.float32)
    ent = (np.inf, -np.inf)
    if c0 > 0 and minmax:
        ent = (suf_mn[0], suf_mx[0]) if full else (pre_mn[0], pre_mx[0])
    for t in range(T):
        k = int(kk[t])
        if k == 0:
            sums[t], counts[t] = runsum0, c0
            mins[t], maxs[t] = ent
            continue
        j = k - 1
        sums[t], counts[t] = d[j], min(c0 + k, W)
        if minmax:
            e = c0 + j
            s0 = max(0, e - W + 1)
            mn, mx = float(pre_mn[e - pre_lo]), float(pre_mx[e - pre_lo])
            if s0 % W != 0:
                mn = _nan_min(float(suf_mn[s0]), mn)
                mx = _nan_max(float(suf_mx[s0]), mx)
            mins[t], maxs[t] = mn, mx
    # 6. write-back: the last min(a, W) slots
    for j in range(max(0, a - W), a):
        ring[(pos0 + j) % W] = nv[j]
    if a == 0:
        return pos0, c0, f32(runsum0), f32(comp0), sums, counts, mins, maxs
    return ((pos0 + a) % W, min(c0 + a, W), rs, cp, sums, counts, mins,
            maxs)


def _model_step(carry, values, accepted, W, minmax):
    """The kernel model over all lanes: numpy carry tuple in, out."""
    ring = carry[0].copy()
    lanes = [_model_lane(ring[p], int(carry[1][p]), int(carry[2][p]),
                         carry[3][p], carry[4][p], values[p], accepted[p],
                         W, minmax) for p in range(len(ring))]
    pos, cnt, rs, cp, sums, counts, mins, maxs = zip(*lanes)
    new = (ring, np.asarray(pos, np.int32), np.asarray(cnt, np.int32),
           np.asarray(rs, np.float32), np.asarray(cp, np.float32))
    outs = [np.stack(sums), np.stack(counts)]
    if minmax:
        outs += [np.stack(mins), np.stack(maxs)]
    return new, outs


MODEL_P = 4


def _model_feed(rng, T, density, nonfinite):
    v = rng.uniform(0, 10, (MODEL_P, T)).astype(np.float32)
    if nonfinite:
        v[rng.random((MODEL_P, T)) < 0.1] = np.inf
        v[rng.random((MODEL_P, T)) < 0.05] = -np.inf
        v[rng.random((MODEL_P, T)) < 0.05] = np.nan
    return v, rng.random((MODEL_P, T)) < density


@pytest.mark.parametrize("T", [1, 8, 300, "2W+3"])
@pytest.mark.parametrize("W", [1, 7, 16, 1000])
def test_kernel_model_equals_plain(W, T):
    """The kernel's decomposition (compaction, evicted-value gather incl.
    j >= W, chunked van Herk / Gil-Werman over ring ++ N, the Kahan chain
    over accepted events, fill forward, last-writer write-back) equals
    wagg_step_plain exactly, outputs and all five carry leaves, over three
    chained blocks; from a fresh and a partly filled carry, on a finite
    and a +-inf/NaN feed, at densities 0, 0.7 and 1.  The longest case
    (W = 1000, T = 2003) takes each density and each feed once, as the
    plain version's per-event loop makes it the slowest by far."""
    T = 2 * W + 3 if T == "2W+3" else T
    # (density, partly filled carry, +-inf/NaN feed)
    combos = [(d, partial, nonfinite) for d in DENSITIES
              for partial, nonfinite in ((False, False), (True, False),
                                         (True, True))]
    if T > 1000:
        combos = [(0.0, False, False), (0.7, True, True), (1.0, True, False)]
    seen_long = False
    for minmax in (False, True):
        for density, partial, nonfinite in combos:
            rng = np.random.default_rng(
                [W, T, int(minmax), int(10 * density), int(partial),
                 int(nonfinite)])
            carry = make_wagg_carry(MODEL_P, W, device="cpu")
            if partial:
                fill = max(1, W // 2)
                v0 = rng.uniform(0, 10, (MODEL_P, fill)).astype(np.float32)
                carry, _ = wagg_step_plain(
                    carry, torch.from_numpy(v0),
                    torch.ones((MODEL_P, fill), dtype=torch.bool), minmax)
            model = tuple(x.numpy().copy() for x in carry)
            for _ in range(3):
                v, a = _model_feed(rng, T, density, nonfinite)
                model, o_m = _model_step(model, v, a, W, minmax)
                carry, o_p = wagg_step_plain(
                    carry, torch.from_numpy(v), torch.from_numpy(a), minmax)
                seen_long |= bool((a.sum(axis=1) > W).any())
                for x, y in zip(o_m, o_p):
                    assert x.dtype == y.numpy().dtype
                    assert _equal(x, y.numpy()), (minmax, density)
                for name, x, y in zip(WaggCarry._fields, model, carry):
                    assert _equal(x, y.numpy()), (name, minmax, density)
    assert seen_long == (T > W)
