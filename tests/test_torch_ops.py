"""Host-side pieces of the torch port vs their JAX-package originals.

Packing (``ops/pack.pack_blocks`` and the numpy ``assign_rows`` path),
the int32 timestamp-offset helpers (``ops/ts32``), the key routing
(``parallel/shards``) and the torch expression namespace
(``plan/expr_compiler.TorchXP``) are fed the same numpy inputs as the
JAX package's versions and must give equal results: exactly, except the
transcendental math functions, whose libm (torch) and XLA CPU code
differ.  Measured on these inputs: sqrt and exp/log 1 ulp, log10 2 ulp,
a sin+cos+tan sum 128 ulp at a near-cancellation; they are held to
rtol 3e-7 (about 2.5 float32 ulp) plus atol 1e-6 for cancellations.
"""
import numpy as np
import pytest
import torch

import siddhi_tpu.ops.ts32 as jts32
import siddhi_tpu.parallel.shards as jshards
from siddhi_tpu.native_ext import assign_rows as jax_assign_rows
from siddhi_tpu.ops.nfa import pack_blocks as jax_pack_blocks
from siddhi_tpu.plan.expr_compiler import EvalCtx as JEvalCtx
from siddhi_tpu.plan.expr_compiler import ExprCompiler as JExprCompiler
from siddhi_tpu.plan.expr_compiler import Scope as JScope
from siddhi_tpu.compiler import SiddhiCompiler as JCompiler
import siddhi_tpu_torch.native_ext as native_ext
import siddhi_tpu_torch.ops.ts32 as ts32
import siddhi_tpu_torch.parallel.shards as shards
from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.ops.pack import pack_blocks
from siddhi_tpu_torch.plan.expr_compiler import (EvalCtx, ExprCompiler,
                                                 Scope, TorchXP)
from siddhi_tpu_torch.utils.errors import SiddhiAppRuntimeException


@pytest.mark.parametrize("P,n", [(1, 5), (8, 300), (64, 2000), (3, 1)])
def test_pack_blocks_equal(P, n):
    rng = np.random.default_rng(P * 1000 + n)
    pids = rng.integers(0, P, n)
    cols = {"a": rng.uniform(-5, 5, n).astype(np.float32),
            "b": rng.integers(-100, 100, n)}
    ts = 5_000 + np.cumsum(rng.integers(0, 9, n))
    codes = rng.integers(0, 3, n).astype(np.int32)
    bj, rj = jax_pack_blocks(pids, cols, ts, codes, P, base_ts=4_000,
                             return_rows=True)
    bt, rt = pack_blocks(pids, cols, ts, codes, P, base_ts=4_000,
                         return_rows=True)
    assert (rj == rt).all() and bj.keys() == bt.keys()
    for k in bj:
        assert bj[k].dtype == bt[k].dtype and (bj[k] == bt[k]).all(), k
    # T is the busiest lane's event count, never rounded up
    assert bt["__ts"].shape == (P, int(np.bincount(pids, minlength=P).max()))


@pytest.mark.parametrize("P", [1, 7, 1024])
def test_numpy_assign_rows_equals_reference(P, monkeypatch):
    """The port's vectorized numpy path (no _native.so) equals the JAX
    package's assign_rows (native or loop)."""
    monkeypatch.setattr(native_ext, "_load", lambda: None)
    rng = np.random.default_rng(P)
    for n in (0, 1, 33, 5000):
        pids = rng.integers(0, P, n).astype(np.int32)
        r, c, T = native_ext.assign_rows(pids, P)
        rj, cj, Tj = jax_assign_rows(pids, P)
        assert (r == rj).all() and (c == cj).all() and T == Tj


def test_ts32_equal():
    assert ts32.safe_max(1000) == jts32.safe_max(1000)
    rng = np.random.default_rng(3)
    ring = rng.integers(-(1 << 31), (1 << 31) - 1, (4, 6)).astype(np.int32)
    for delta in (0, 17, 1 << 33):
        want = np.asarray(jts32.shift_clamped(ring, delta, -5))
        assert (ts32.shift_clamped(ring, delta, -5) == want).all()
        got = ts32.shift_clamped(torch.from_numpy(ring), delta, -5)
        assert isinstance(got, torch.Tensor) and (got.numpy() == want).all()


@pytest.mark.parametrize("case", ["first", "in_range", "rebase", "invalid"])
def test_rebase_offsets_equal(case):
    empty = np.iinfo(np.int32).min
    base = None if case == "first" else 1 << 41
    src = (1 << 41) + np.arange(6, dtype=np.int64) * 1000
    valid = np.ones(6, bool)
    if case == "rebase":
        src = src + (1 << 31)
    if case == "invalid":
        valid[::2] = False
    ring = np.array([[empty, 5, 9], [100, empty, -3]], np.int32)
    oj, bj, rj = jts32.rebase_offsets(src, valid, base, 500, ring, empty)
    for ring_in in (ring, torch.from_numpy(ring)):
        ot, bt, rt = ts32.rebase_offsets(src, valid, base, 500, ring_in,
                                         empty)
        assert (ot == oj).all() and bt == bj
        rt = rt.numpy() if isinstance(rt, torch.Tensor) else rt
        assert (np.asarray(rt) == np.asarray(rj)).all()


def test_rebase_offsets_rejects_far_past():
    src = np.array([0, 1], np.int64)
    with pytest.raises(SiddhiAppRuntimeException):
        ts32.rebase_offsets(src, np.ones(2, bool), 1 << 33, 500, None, 0)


def test_shard_routing_equal():
    assert shards.routing_digest() == jshards.routing_digest()
    keys = np.asarray([f"k{i}" for i in range(500)] + ["", "é", "12"])
    assert (shards.fnv1a_vec(keys) == jshards.fnv1a_vec(keys)).all()
    for n in (2, 3, 8):
        a, b = shards.split_rows(keys, n), jshards.split_rows(keys, n)
        assert [s for s, _ in a] == [s for s, _ in b]
        assert all((x == y).all() for (_, x), (_, y) in zip(a, b))


DEFN = "define stream S (x float, y float, i int, l long, d double);"

EXPRS = {
    "arith": "x * 2.0 - y / 3.0 + 1",
    "int_div": "i / 3",
    "int_mod": "i % 4",
    "float_mod": "x % 1.5",
    "long_mix": "l * 2 + i",
    "double_mix": "d * x",
    "compare_and": "x > 0.5 and not (y <= -1.0) or i == 2",
    "neq": "i != 3",
    "if_then_else": "ifThenElse(x > y, x, y * 2.0)",
    "max_min": "maximum(x, y, 0.0) - minimum(x, 1.0)",
    "cast_int": "cast(x * 10.0, 'int')",
    "abs_floor_ceil": "math:abs(x) + math:floor(y) - math:ceil(x)",
    "round": "math:round(x * 4.0)",
    "sqrt": "math:sqrt(math:abs(y))",
    "power": "math:power(math:abs(x), 2.0)",
    "exp_log": "math:exp(x) + math:log(math:abs(y) + 1.0)",
    "trig": "math:sin(x) + math:cos(y) + math:tan(x / 4.0)",
    "log10": "math:log10(math:abs(x) + 0.5)",
}
APPROX = {"exp_log", "trig", "log10", "sqrt"}


def _expr(compiler_cls, text):
    app = compiler_cls.parse(DEFN + "\nfrom S[" + text +
                             " != 12345.0] select x insert into O;")
    cmp_expr = app.execution_elements[0].input_stream.handlers[0].expr
    return cmp_expr.left, app.stream_definitions["S"]


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_torch_namespace_matches_jnp(name):
    """The same expression compiled under jax.numpy (the JAX package's
    device programs, x64 off) and under TorchXP on float32 lanes (what
    pack_blocks produces) gives the same dtype and values."""
    import jax.numpy as jnp
    rng = np.random.default_rng(len(name))
    n = 257
    cols = {"x": rng.uniform(-4, 4, n), "y": rng.uniform(-4, 4, n),
            "i": rng.integers(-20, 20, n), "l": rng.integers(-99, 99, n),
            "d": rng.uniform(-1e3, 1e3, n)}
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    cols["x"][:4] = [0.5, 1.5, 2.5, -0.5]          # round half to even
    ts = np.zeros(n, np.int32)

    ej, dj = _expr(JCompiler, EXPRS[name])
    sj = JScope()
    sj.add_primary("S", None, dj)
    cj = JExprCompiler(sj, jnp).compile(ej)
    want = np.asarray(cj.fn(JEvalCtx({k: jnp.asarray(v)
                                       for k, v in cols.items()},
                                      jnp.asarray(ts), n)))

    et, dt = _expr(SiddhiCompiler, EXPRS[name])
    st = Scope()
    st.add_primary("S", None, dt)
    xp = TorchXP("cpu")
    ct = ExprCompiler(st, xp).compile(et)
    assert ct.type.value == cj.type.value
    got = ct.fn(EvalCtx({k: torch.from_numpy(v) for k, v in cols.items()},
                        torch.from_numpy(ts), n))
    got = xp.tensor(got).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if name in APPROX:
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-6)
    else:
        assert (got == want).all()


def test_torch_namespace_dtypes():
    xp = TorchXP("cpu")
    assert xp.asarray(np.float64(1.5), np.float64).dtype == torch.float32
    assert xp.asarray(np.int64(7), np.int64).dtype == torch.int32
    assert xp.full(3, True, bool).dtype == torch.bool
    assert xp.round(torch.tensor([0.5, 1.5, 2.5])).tolist() == [0, 2, 2]
    assert xp.fmod(torch.tensor([-7.0, 7.0]), 3.0).tolist() == [-1.0, 1.0]
