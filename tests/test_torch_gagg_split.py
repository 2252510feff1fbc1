"""The split design of the grouped-aggregation kernels (K7), on the CPU.

``csrc/grouped_agg.cu`` splits a lane's events across the card: ranks and
per-group chains by tiled counting passes, a serial walk per group for the
running sums, a range per event for the windowed planes.  Its CPU model,
``ops/grouped_agg.grouped_split_model``, runs those passes literally with
the tile size and the short-range limit as parameters.  Here the model is
held bit for bit (tolerance 0; NaN positions compared, payloads not part of
the contract) against the plain twins ``grouped_step_plain`` and
``grouped_time_step_plain`` — which ``tests/test_torch_grouped_agg.py``
holds against the JAX package — on chained blocks made from a seed with
numpy: tiles of 4 and 7 events, so every case crosses tile boundaries and
wraps its ring inside a tile, and short-range limits that send ranges to
both the one-thread and the warp path.
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


def _feed(rng, case, T, dens, t0):
    P, n_groups, VF, VI = case["P"], case["G"], case["VF"], case["VI"]
    f = rng.uniform(-50, 50, (P, T, VF)).astype(np.float32)
    i = rng.integers(-1000, 1000, (P, T, VI)).astype(np.int32)
    if case.get("feed") == "nonfinite":
        r = rng.random((P, T, VF))
        f[r < 0.06] = np.inf
        f[(r >= 0.06) & (r < 0.12)] = -np.inf
        f[(r >= 0.12) & (r < 0.17)] = np.nan
        f[(r >= 0.17) & (r < 0.3)] = -0.0
        f[(r >= 0.3) & (r < 0.4)] = 0.0
        r = rng.random((P, T, VI))
        i[r < 0.25] = (1 << 31) - 1
        i[r > 0.75] = -((1 << 31) - 1)
    g = rng.integers(0, n_groups, (P, T)).astype(np.int32)
    if case.get("gids") == "skew":
        g[rng.random((P, T)) < 0.5] = 0
    ts = (t0 + np.cumsum(rng.integers(0, 3, (P, T)), axis=1)).astype(
        np.int32)
    if case.get("ts") == "jitter":
        ts = (ts + rng.integers(0, 12, (P, T))).astype(np.int32)
    ok = rng.random((P, T)) < dens
    return f, i, g, ts, ok


def _grow(carry, n_groups):
    """The group slabs widened, as plan/gagg_compiler._grow_groups does."""
    P, W = carry.ring_gid.shape
    VF, VI = carry.ring_f.shape[2], carry.ring_i.shape[2]
    time = isinstance(carry, G.GroupedTimeCarry)
    make = G.make_grouped_time_carry if time else G.make_grouped_carry
    pad = make(P, W, n_groups - carry.fmin_f.shape[1], VF, VI, "cpu")
    fields = ["fmin_f", "fmax_f", "fmin_i", "fmax_i"]
    if not time:
        fields += ["fsum_hi", "fsum_lo", "isum_hi", "isum_lo", "gcnt"]
    return carry._replace(**{
        f: torch.cat([getattr(carry, f), getattr(pad, f)], 1).contiguous()
        for f in fields})


# kind "length" (K7a; W 0: the running mode) or "time" (K7b: W the ring's
# capacity, ms its window); T per block; dens per block (default 0.7);
# fill: a block of accepted events first (a partly filled carry);
# grow: the group slabs widened to this G before the last block;
# restored: the first block run by the JAX package and its carry taken
# through carry_from_reference
CASES = {
    "one_chain": dict(kind="length", P=3, W=6, G=1, VF=1, VI=1,
                      T=(30, 25), minmax=True, forever=True),
    "one_chain_time": dict(kind="time", P=3, W=8, ms=9, G=1, VF=1, VI=1,
                           T=(30, 25), forever=True),
    "skew": dict(kind="length", P=4, W=9, G=6, VF=2, VI=1, T=(40, 33),
                 minmax=True, gids="skew"),
    "skew_time": dict(kind="time", P=4, W=16, ms=12, G=6, VF=1, VI=1,
                      T=(40, 33), gids="skew"),
    "nonfinite": dict(kind="length", P=4, W=7, G=3, VF=2, VI=2,
                      T=(30, 30), minmax=True, forever=True,
                      feed="nonfinite"),
    "nonfinite_time": dict(kind="time", P=4, W=8, ms=6, G=3, VF=2, VI=2,
                           T=(30, 30), forever=True, feed="nonfinite"),
    "running": dict(kind="length", P=4, W=0, G=3, VF=2, VI=1, T=(25, 20),
                    minmax=True, feed="nonfinite"),
    "running_forever": dict(kind="length", P=3, W=0, G=4, VF=1, VI=2,
                            T=(25, 20), forever=True),
    "inplace": dict(kind="length", P=3, W=5, G=3, VF=1, VI=1, T=(23, 29),
                    minmax=True, inplace=True),
    "sum_only": dict(kind="length", P=3, W=8, G=4, VF=1, VI=1, T=(30, 18)),
    "partly_filled": dict(kind="length", P=3, W=12, G=3, VF=1, VI=1,
                          T=(9, 6), fill=5, minmax=True),
    "partly_filled_time": dict(kind="time", P=3, W=16, ms=40, G=3, VF=1,
                               VI=1, T=(9, 6), fill=5),
    "restored": dict(kind="length", P=3, W=6, G=3, VF=2, VI=1, T=(17, 21),
                     minmax=True, forever=True, restored=True,
                     feed="nonfinite"),
    "restored_time": dict(kind="time", P=3, W=8, ms=7, G=3, VF=1, VI=1,
                          T=(17, 21), forever=True, restored=True),
    "growth": dict(kind="length", P=3, W=7, G=2, VF=1, VI=1, T=(20, 20),
                   grow=5, minmax=True, forever=True),
    "growth_time": dict(kind="time", P=3, W=8, ms=10, G=2, VF=1, VI=1,
                        T=(20, 20), grow=5, forever=True),
    # no overflow in the first block (6 entries in a ring of 16); in the
    # second the ring is full from its eleventh accepted event on (past
    # the second tile of 4 and the first of 7), every entry inside the
    # window: the flag rises mid-block, after a tile boundary
    "overflow_mid_block": dict(kind="time", P=3, W=16, ms=1000, G=3, VF=1,
                               VI=1, T=(6, 24), dens=(1.0, 0.8)),
    "jitter": dict(kind="time", P=4, W=16, ms=9, G=4, VF=1, VI=1,
                   T=(30, 30), ts="jitter", feed="nonfinite"),
    "short_block": dict(kind="length", P=3, W=5, G=2, VF=1, VI=1,
                        T=(3, 2, 3), minmax=True),
    "short_block_time": dict(kind="time", P=3, W=4, ms=5, G=2, VF=1, VI=1,
                             T=(3, 2, 3)),
}


def _plain(case):
    if case["kind"] == "time":
        return G.grouped_time_step_plain(case["ms"], case["W"],
                                         case.get("forever", False))
    return G.grouped_step_plain(case["W"], case.get("minmax", False),
                                case.get("forever", False))


def _model(case, tile, short):
    kw = dict(want_forever=case.get("forever", False), tile=tile,
              short=short)
    if case["kind"] == "time":
        return lambda c, f, i, g, ts, ok: G.grouped_split_model(
            c, f, i, g, ts, ok, window_ms=case["ms"], **kw)
    return lambda c, f, i, g, ok: G.grouped_split_model(
        c, f, i, g, None, ok, want_minmax=case.get("minmax", False),
        inplace=case.get("inplace", False), **kw)


def _restored_carry(case, rng):
    """The JAX package's step over a first block, its carry through
    carry_from_reference; returns (carry, t0)."""
    P, W, VF, VI = case["P"], case["W"], case["VF"], case["VI"]
    f, i, g, ts, ok = _feed(rng, case, 11, 0.8, 0)
    if case["kind"] == "time":
        jc, _ = J.build_grouped_time_step(case["ms"], W, True)(
            J.make_grouped_time_carry(P, W, case["G"], VF, VI),
            f, i, g, ts, ok)
    else:
        jc, _ = J.build_grouped_step(W, True, True)(
            J.make_grouped_carry(P, W, case["G"], VF, VI), f, i, g, ok)
    state = {"carry": [np.asarray(a) for a in jc]}
    return G.carry_from_reference(state, device="cpu"), int(ts.max()) + 1


@pytest.mark.parametrize("tile,short", [(4, 2), (7, G.SPLIT_SHORT)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_model_equals_plain(name, tile, short):
    case = dict(CASES[name])
    rng = np.random.default_rng(sum(map(ord, name)) + tile)
    time = case["kind"] == "time"
    make = G.make_grouped_time_carry if time else G.make_grouped_carry
    t0 = 0
    if case.get("restored"):
        cp, t0 = _restored_carry(case, rng)
    else:
        cp = make(case["P"], case["W"], case["G"], case["VF"], case["VI"],
                  "cpu")
    cm = type(cp)(*[a.clone() for a in cp])
    plain, model = _plain(case), _model(case, tile, short)
    dens = case.get("dens", (0.7,) * len(case["T"]))
    blocks = list(zip(case["T"], dens))
    if case.get("fill"):
        blocks.insert(0, (case["fill"], 1.0))
    for bi, (T, d) in enumerate(blocks):
        if case.get("grow") and bi == len(blocks) - 1:
            cp, cm = _grow(cp, case["grow"]), _grow(cm, case["grow"])
            case["G"] = case["grow"]
        f, i, g, ts, ok = _feed(rng, case, T, d, t0)
        t0 = int(ts.max()) + 1
        ev = [torch.from_numpy(a) for a in (f, i, g)]
        okt = torch.from_numpy(ok)
        args = ev + ([torch.from_numpy(ts)] if time else []) + [okt]
        given = cm
        cp, op = plain(cp, *args)
        cm, om = model(cm, *args)
        if case.get("inplace"):
            assert all(a is b for a, b in zip(cm, given))
        where = f"{name} tile={tile} short={short} block {bi} (T={T})"
        assert len(op) == len(om) == 13
        for k, (a, b) in enumerate(zip(op, om)):
            assert _same(a.numpy(), b.numpy()), f"{where}: output {k}"
        for field, a, b in zip(type(cp)._fields, cp, cm):
            assert _same(a.numpy(), b.numpy()), f"{where}: carry {field}"
        if name == "overflow_mid_block":
            assert bool(cm.overflow.any()) == (bi == 1), where


def test_split_model_default_geometry_and_warp_path():
    """The model's default tile (split_tile) and the short limit 0 (every
    range to the warp path, the kernel's kShort = 0 build) over a lane
    longer than one tile; split_tile's rule at the cells' shapes and at
    the shape chip_smoke.py's phase 12 gives for its doubling."""
    assert G.split_tile(1, 262_144, 1000, 1024) == 256
    assert G.split_tile(1024, 512, 1000, 8) == 256
    assert G.split_tile(4, 100, 8, 3) == 256
    assert G.split_tile(256, 400, 300, 16384) == 512
    assert G.split_tile(256, 280, 512, 16384) == 512
    case = dict(kind="length", P=2, W=40, G=3, VF=1, VI=1, minmax=True,
                forever=True)
    rng = np.random.default_rng(5)
    cp = G.make_grouped_carry(2, 40, 3, 1, 1, "cpu")
    cm = type(cp)(*[a.clone() for a in cp])
    for T in (300, 60):
        f, i, g, _, ok = _feed(rng, case, T, 0.8, 0)
        args = [torch.from_numpy(a) for a in (f, i, g, ok)]
        cp, op = _plain(case)(cp, *args)
        cm, om = G.grouped_split_model(cm, *args[:3], None, args[3],
                                       want_minmax=True, want_forever=True,
                                       short=0)
        for a, b in list(zip(op, om)) + list(zip(cp, cm)):
            assert _same(a.numpy(), b.numpy())


@pytest.mark.parametrize("W", [1, 2, 8, 64])
def test_sparse_tree_equals_pair_tree_sum(W):
    """_sparse_tree (the kernel's short-range tree: live slots in
    bit-reversed order, siblings neighbours) gives _pair_tree_sum's bits
    on masks from one live slot to all, with -0.0, ±inf and NaN."""
    rng = np.random.default_rng(W)
    with np.errstate(all="ignore"):
        for trial in range(30):
            v = rng.uniform(-100, 100, W).astype(np.float32)
            r = rng.random(W)
            v[r < 0.1] = -0.0
            v[(r >= 0.1) & (r < 0.15)] = 0.0
            v[(r >= 0.15) & (r < 0.17)] = np.inf
            v[(r >= 0.17) & (r < 0.19)] = -np.inf
            v[(r >= 0.19) & (r < 0.2)] = np.nan
            live = rng.random(W) < (0.1, 0.4, 1.0)[trial % 3]
            vt = torch.from_numpy(v)
            want = G._pair_tree_sum(vt, torch.from_numpy(live), 0)
            leaves = [(int(s), vt[s])
                      for s in rng.permutation(np.flatnonzero(live))]
            got = G._sparse_tree(leaves, W, torch.zeros(()))
            assert _same(torch.stack(want).numpy(),
                         torch.stack(got).numpy()), (W, trial)
