"""The grouped-aggregation steps (K7): JAX package vs torch port.

``siddhi_tpu/ops/grouped_agg.py`` ``build_grouped_step`` and
``build_grouped_time_step`` (jitted on JAX's CPU backend) and the port's
plain twins ``grouped_step_plain`` / ``grouped_time_step_plain`` run the
same chained blocks, made from a seed with numpy, from the same carry.
Every one of the 13 outputs (14 with numguard) and every carry leaf must
be equal bit for bit (tolerance 0; NaN payloads aside, NaN positions
included).  Cases: the running mode (window 0), length windows, min/max
and forever lanes on and off, numguard, a NaN/±inf/-0.0/+0.0 feed, every
eviction in the arriving group (G = 1), int values at ±(2^31 - 1), time
windows with and without ring overflow, and ``carry_from_reference``
round trips.  On the CPU the kernel entry points run the plain twins.
"""
import numpy as np
import pytest
import torch

import siddhi_tpu.ops.grouped_agg as J
import siddhi_tpu_torch.ops.grouped_agg as G


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        na, nb = np.isnan(a), np.isnan(b)
        return bool((na == nb).all() and
                    (a.view(np.int32)[~na] == b.view(np.int32)[~nb]).all())
    return bool((a == b).all())


def _feed(rng, P, T, VF, VI, n_groups, feed, dens=0.8):
    f = rng.uniform(-50, 50, (P, T, VF)).astype(np.float32)
    i = rng.integers(-1000, 1000, (P, T, VI)).astype(np.int32)
    if feed == "special":
        r = rng.random((P, T, VF))
        f[r < 0.08] = np.inf
        f[(r >= 0.08) & (r < 0.16)] = -np.inf
        f[(r >= 0.16) & (r < 0.22)] = np.nan
        f[(r >= 0.22) & (r < 0.32)] = -0.0
        f[(r >= 0.32) & (r < 0.42)] = 0.0
    if feed in ("special", "int_edges"):
        r = rng.random((P, T, VI))
        i[r < 0.2] = (1 << 31) - 1
        i[r > 0.8] = -((1 << 31) - 1)
    g = rng.integers(0, n_groups, (P, T)).astype(np.int32)
    ok = rng.random((P, T)) < dens
    return f, i, g, ok


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_equal(jo, to, jc, tc, fields, where):
    assert len(jo) == len(to), where
    for k, (a, b) in enumerate(zip(jo, to)):
        assert _same(a, b.numpy()), f"{where}: output {k}"
    for name, a, b in zip(fields, jc, tc):
        assert _same(a, b.numpy()), f"{where}: carry leaf {name}"


# (window, want_minmax, want_forever, numguard, groups)
LENGTH = {
    "running_minmax": (0, True, False, False, 3),
    "running_forever": (0, False, True, False, 3),
    "running_sum_only": (0, False, False, False, 4),
    "length_minmax": (8, True, False, False, 3),
    "length_minmax_forever": (5, True, True, False, 3),
    "length_sum_only": (16, False, False, False, 5),
    "length_evicts_own_group": (4, True, True, False, 1),
    "length_numguard": (6, True, False, True, 3),
    "running_numguard": (0, True, True, True, 2),
}


@pytest.mark.parametrize("feed", ["uniform", "special", "int_edges"])
@pytest.mark.parametrize("name", sorted(LENGTH))
def test_grouped_step_plain_equals_jax(name, feed):
    W, minmax, forever, numguard, n_groups = LENGTH[name]
    rng = np.random.default_rng(sum(map(ord, name + feed)))
    P, VF, VI = 5, 2, 2
    jc = J.make_grouped_carry(P, W, n_groups, VF, VI)
    tc = G.make_grouped_carry(P, W, n_groups, VF, VI, device="cpu")
    jstep = J.build_grouped_step(W, minmax, forever, numguard=numguard)
    tstep = G.grouped_step_plain(W, minmax, forever, numguard=numguard)
    for T in (16, 32, 8):                 # T >= W, then below it
        f, i, g, ok = _feed(rng, P, T, VF, VI, n_groups, feed)
        jc, jo = jstep(jc, f, i, g, ok)
        tc, to = tstep(tc, *_tensors(f, i, g, ok))
        _assert_equal(jo, to, jc, tc, J.GroupedAggCarry._fields,
                      f"{name}/{feed} T={T}")
    assert len(to) == (14 if numguard else 13)


# (window_ms, capacity, want_forever)
TIME = {
    "time_short": (5, 8, False),
    "time_forever": (20, 8, True),
    "time_overflow": (40, 4, True),
    "time_wide": (100, 16, False),
}


@pytest.mark.parametrize("feed", ["uniform", "special"])
@pytest.mark.parametrize("name", sorted(TIME))
def test_grouped_time_step_plain_equals_jax(name, feed):
    window_ms, cap, forever = TIME[name]
    rng = np.random.default_rng(sum(map(ord, name + feed)))
    P, VF, VI, n_groups = 4, 2, 1, 3
    jc = J.make_grouped_time_carry(P, cap, n_groups, VF, VI)
    tc = G.make_grouped_time_carry(P, cap, n_groups, VF, VI, device="cpu")
    jstep = J.build_grouped_time_step(window_ms, cap, forever)
    tstep = G.grouped_time_step_plain(window_ms, cap, forever)
    t0 = 0
    for T in (16, 32):
        f, i, g, ok = _feed(rng, P, T, VF, VI, n_groups, feed)
        ts = (t0 + np.cumsum(rng.integers(0, 3, (P, T)), axis=1)).astype(
            np.int32)
        t0 = int(ts.max())
        jc, jo = jstep(jc, f, i, g, ts, ok)
        tc, to = tstep(tc, *_tensors(f, i, g, ts, ok))
        _assert_equal(jo, to, jc, tc, J.GroupedTimeCarry._fields,
                      f"{name}/{feed} T={T}")
    if name == "time_overflow":
        assert np.asarray(jc.overflow).all()


@pytest.mark.parametrize("kind", ["length", "time"])
def test_kernel_entry_points_run_the_plain_twin_on_cpu(kind):
    """On CPU tensors the kernel entry points are the plain twins (no
    launch is counted); the port's carry is int32/float32/bool."""
    rng = np.random.default_rng(7)
    f, i, g, ok = _feed(rng, 3, 16, 1, 1, 2, "uniform")
    n0 = (G.grouped_step.launches, G.grouped_time_step.launches)
    if kind == "length":
        c = G.make_grouped_carry(3, 4, 2, 1, 1, device="cpu")
        out_k = G.grouped_step(4, True, True)(c, *_tensors(f, i, g, ok))
        out_p = G.grouped_step_plain(4, True, True)(c, *_tensors(f, i, g,
                                                                ok))
        dts = G.LENGTH_DTYPES
    else:
        ts = np.cumsum(rng.integers(0, 3, (3, 16)), axis=1).astype(np.int32)
        c = G.make_grouped_time_carry(3, 8, 2, 1, 1, device="cpu")
        args = _tensors(f, i, g, ts, ok)
        out_k = G.grouped_time_step(10, 8, True)(c, *args)
        out_p = G.grouped_time_step_plain(10, 8, True)(c, *args)
        dts = G.TIME_DTYPES
    for a, b in zip(list(out_k[0]) + list(out_k[1]),
                    list(out_p[0]) + list(out_p[1])):
        assert _same(a.numpy(), b.numpy())
    assert [t.dtype for t in out_k[0]] == list(dts)
    assert (G.grouped_step.launches, G.grouped_time_step.launches) == n0


@pytest.mark.parametrize("kind", ["length", "time"])
def test_carry_from_reference_round_trip(kind):
    """A JAX carry (numpy leaves, as current_state() gives them) becomes
    the port's carry with the same bits and dtypes, and back."""
    rng = np.random.default_rng(11)
    f, i, g, ok = _feed(rng, 3, 16, 2, 1, 3, "special")
    if kind == "length":
        jc, _ = J.build_grouped_step(4, True, True)(
            J.make_grouped_carry(3, 4, 3, 2, 1), f, i, g, ok)
    else:
        ts = np.cumsum(rng.integers(0, 3, (3, 16)), axis=1).astype(np.int32)
        jc, _ = J.build_grouped_time_step(10, 8, True)(
            J.make_grouped_time_carry(3, 8, 3, 2, 1), f, i, g, ts, ok)
    leaves = [np.asarray(a) for a in jc]
    for state in ({"carry": leaves}, leaves):
        tc = G.carry_from_reference(state, device="cpu")
        assert type(tc).__name__ == type(jc).__name__
        for a, b in zip(leaves, tc):
            assert b.is_contiguous()
            assert _same(a, b.numpy())
    with pytest.raises(ValueError, match="leaves"):
        G.carry_from_reference(leaves[:5], device="cpu")
    # a ring that does not fill from slot 0 is no state a step makes
    broken = [a.copy() for a in leaves]
    i_pos = type(jc)._fields.index("pos")
    i_cnt = type(jc)._fields.index("cnt")
    broken[i_cnt][:] = 1
    broken[i_pos][:] = 2
    with pytest.raises(ValueError, match="fills from slot 0"):
        G.carry_from_reference(broken, device="cpu")


def test_sentinel_plane_and_int_reassembly_equal_jax():
    rng = np.random.default_rng(3)
    fhi = rng.uniform(-1, 1, (2, 3, 2)).astype(np.float32)
    fhi[0, 1, 0] = np.inf
    fhi[1, 2, 1] = np.nan
    ihi = rng.integers(-40000, 40000, (2, 3, 2)).astype(np.int32)
    ilo = rng.integers(0, 65536, (2, 3, 2)).astype(np.int32)
    ihi[0, 0, 0] = 32000
    gcnt = rng.integers(0, 5, (2, 3)).astype(np.int32)
    gcnt[1, 1] = 2_000_000_000
    want = np.asarray(J.sentinel_plane(fhi, ihi, ilo, gcnt))
    got = G.sentinel_plane(*_tensors(fhi, ihi, ilo, gcnt)).numpy()
    assert _same(want, got)
    assert want[0] > 0 and want[1:].tolist() == [1, 2]
    assert (G.reassemble_int_sums(ihi, ilo) ==
            J.reassemble_int_sums(ihi, ilo)).all()


def test_sentinel_plane_counts_flags():
    """tests/test_numguard.py's case of the same name (it builds its
    planes with jax.numpy), on the port's torch tensors."""
    near = int(0.95 * (1 << 31))
    hi, lo = near // 65536, near % 65536
    fsum_hi = torch.tensor([[1.0, float("inf")], [float("nan"), 2.0]],
                           dtype=torch.float32)
    isum_hi = torch.tensor([[hi, 0], [0, 0]], dtype=torch.int32)
    isum_lo = torch.tensor([[lo, 0], [0, 0]], dtype=torch.int32)
    gcnt = torch.tensor([[2_000_000_000, 3], [1, 0]], dtype=torch.int32)
    plane = G.sentinel_plane(fsum_hi, isum_hi, isum_lo, gcnt)
    assert plane.tolist() == [1, 1, 2]     # near-int, near-cnt, nonfinite


def test_sentinel_plane_all_clear():
    """tests/test_numguard.py's case of the same name, on torch tensors."""
    z = torch.zeros((3, 4), dtype=torch.int32)
    f = torch.ones((3, 4), dtype=torch.float32)
    assert G.sentinel_plane(f, z, z, z).tolist() == [0, 0, 0]


def _sparse_tree_model(vals, live_slots, width):
    """csrc/grouped_agg.cu sparse_tree in numpy float32: the pairwise
    two-float tree over `width` leaves computed only above the live
    slots (a node with no live leaf below it is (+0.0, +0.0))."""
    f32 = np.float32

    def two_sum(a, b):
        s = f32(a + b)
        bb = f32(s - a)
        return s, f32(f32(a - f32(s - bb)) + f32(b - bb))

    nodes = {int(s): (f32(vals[s]), f32(0.0)) for s in live_slots}
    w = width
    while w > 1:
        half = w >> 1
        pairs = {}
        for i, node in nodes.items():
            a, b = pairs.get(i & (half - 1), ((f32(0.0),) * 2,) * 2)
            pairs[i & (half - 1)] = (a, node) if i & half else (node, b)
        nodes = {}
        for j, ((ah, al), (bh, bl)) in pairs.items():
            s, e = two_sum(ah, bh)
            lo2 = f32(f32(al + bl) + e)
            h = f32(s + lo2)
            nodes[j] = (h, f32(lo2 - f32(h - s)))
        w = half
    return nodes.get(0, (f32(0.0), f32(0.0)))


@pytest.mark.parametrize("width", [1, 2, 8, 64, 1024])
def test_kernel_sparse_tree_equals_pair_tree_sum(width):
    """The time kernel rebuilds _pair_tree_sum from a short group's live
    slots alone; its model gives the dense tree's bits on masks from one
    live leaf to all, with -0.0, ±inf and NaN among the values."""
    rng = np.random.default_rng(width)
    with np.errstate(all="ignore"):
        for trial in range(40):
            v = rng.uniform(-100, 100, width).astype(np.float32)
            r = rng.random(width)
            v[r < 0.1] = -0.0
            v[(r >= 0.1) & (r < 0.15)] = 0.0
            v[(r >= 0.15) & (r < 0.17)] = np.inf
            v[(r >= 0.17) & (r < 0.19)] = -np.inf
            v[(r >= 0.19) & (r < 0.2)] = np.nan
            live = rng.random(width) < (0.05, 0.3, 1.0)[trial % 3]
            hi, lo = G._pair_tree_sum(torch.from_numpy(v),
                                      torch.from_numpy(live), 0)
            want = np.array([hi.item(), lo.item()], np.float32)
            got = np.array(_sparse_tree_model(
                v, rng.permutation(np.flatnonzero(live)), width),
                np.float32)
            assert _same(want, got), (width, trial)
