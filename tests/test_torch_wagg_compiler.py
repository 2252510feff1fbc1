"""The torch port's CompiledWindowedAgg vs the JAX package's.

Both compile the same query (filter + value expression + length-window
step) and are fed the same ``pack_blocks`` feeds (the JAX package's own
test generator).  The JAX side runs its public-path configuration
(``use_pallas=False``, the jnp scan); the port runs its plain PyTorch
version on the CPU.  Every output block, the final carry and
``current_aggregates`` must be EXACTLY equal: the filter/value program
and the step run the same float32 operations on both sides.
"""
import numpy as np
import pytest
import torch

from siddhi_tpu.ops.nfa import pack_blocks as jax_pack_blocks
from siddhi_tpu.plan.wagg_compiler import \
    CompiledWindowedAgg as JaxCompiledWindowedAgg
from siddhi_tpu_torch.ops.pack import pack_blocks
from siddhi_tpu_torch.plan.wagg_compiler import (CompiledWindowedAgg,
                                                 carry_from_reference)
from siddhi_tpu_torch.utils.errors import SiddhiAppCreationError

APP = """
define stream S (k int, v float);
@info(name='q')
from S[v > 2.0]#window.length(5)
select k, sum(v) as total, count() as n
group by k
insert into Out;
"""

MINMAX_APP = """
define stream S (k int, v float);
@info(name='q')
from S[v > 2.0]#window.length(5)
select k, min(v) as lo, max(v) as hi, sum(v) as total
group by k
insert into Out;
"""

EXPR_APP = """
define stream S (k int, v float);
@info(name='q')
from S[v * 2.0 - 1.5 > 3.0 and not (v > 9.5)]#window.length(7)
select k, sum(v / 4.0 + 1.0) as total, avg(v / 4.0 + 1.0) as a,
       count() as n, max(v / 4.0 + 1.0) as hi
group by k
insert into Out;
"""


def gen(seed, n, n_partitions):
    """The JAX package's feed generator (tests/test_tpu_wagg.py)."""
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, n_partitions, n)
    vals = rng.uniform(0.0, 10.0, n).astype(np.float32)
    ts = 1_000_000 + np.arange(n, dtype=np.int64)
    return pids, vals, ts


def feeds(seed, n, P, chunk):
    pids, vals, ts = gen(seed, n, P)
    cols = {"k": pids.astype(np.float32), "v": vals}
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        yield (pids[i:j], {k: v[i:j] for k, v in cols.items()}, ts[i:j],
               np.zeros(j - i, np.int32))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert ((a == b) | (np.isnan(a) & np.isnan(b))).all() \
        if a.dtype.kind == "f" else (a == b).all()


def _step_both(jx, pt, args, P):
    bj = jax_pack_blocks(*args, P, base_ts=int(args[2][0]))
    bt = pack_blocks(*args, P, base_ts=int(args[2][0]))
    for k in bj:
        _same(bj[k], bt[k])
    oj = jx.process_block(bj)
    ot = pt.process_block(bt)
    assert len(oj) == len(ot)
    for x, y in zip(oj, ot):
        _same(np.asarray(x), y.numpy())


def _same_state(jx, pt):
    sj, st = jx.current_state(), pt.current_state()
    assert sj["n_partitions"] == st["n_partitions"]
    assert sj["window"] == st["window"]
    for x, y in zip(sj["carry"], st["carry"]):
        _same(x, y)
    aj, at = jx.current_aggregates(), pt.current_aggregates()
    assert aj.keys() == at.keys()
    for k in aj:
        _same(aj[k], at[k])


@pytest.mark.parametrize("app", [APP, MINMAX_APP, EXPR_APP],
                         ids=["sum_count", "minmax", "expressions"])
@pytest.mark.parametrize("chunk", [7, 64, 200])
def test_compiled_wagg_matches_jax(app, chunk):
    P = 16
    jx = JaxCompiledWindowedAgg(app, n_partitions=P, t_per_block=32,
                                use_pallas=False)
    pt = CompiledWindowedAgg(app, n_partitions=P, device="cpu")
    assert pt.want_minmax == jx.want_minmax
    assert pt.outputs == jx.outputs
    for args in feeds(5, 400, P, chunk):
        _step_both(jx, pt, args, P)
    _same_state(jx, pt)


@pytest.mark.parametrize("app", [APP, MINMAX_APP], ids=["sum", "minmax"])
def test_grow_matches_jax(app):
    """Lane growth mid-stream (keyed slab doubling) on both sides."""
    jx = JaxCompiledWindowedAgg(app, n_partitions=4, use_pallas=False)
    pt = CompiledWindowedAgg(app, n_partitions=4, device="cpu")
    for args in feeds(11, 120, 4, 40):
        _step_both(jx, pt, args, 4)
    jx.grow(16)
    pt.grow(16)
    assert pt.n_partitions == jx.n_partitions == 16
    for args in feeds(12, 300, 16, 50):
        _step_both(jx, pt, args, 16)
    _same_state(jx, pt)


@pytest.mark.parametrize("app", [APP, MINMAX_APP], ids=["sum", "minmax"])
def test_state_carried_from_jax(app):
    """Run the first half in the JAX package, carry its state across with
    carry_from_reference / restore_state, continue both: equal results."""
    P = 16
    chunks = list(feeds(21, 600, P, 100))
    jx = JaxCompiledWindowedAgg(app, n_partitions=P, use_pallas=False)
    for args in chunks[:3]:
        jx.process_block(jax_pack_blocks(*args, P,
                                         base_ts=int(args[2][0])))
    state = jx.current_state()
    carry = carry_from_reference(state, "cpu")
    assert carry.pos.dtype == torch.int32 and carry.ring.shape == (P, 5)
    pt = CompiledWindowedAgg(app, n_partitions=P, device="cpu")
    pt.restore_state(state)
    _same_state(jx, pt)
    for args in chunks[3:]:
        _step_both(jx, pt, args, P)
    _same_state(jx, pt)


def test_time_windows_not_yet_ported():
    """Time windows were refused here until K6 was ported: both kinds now
    compile onto the time step, externalTime reading its attribute."""
    for window, ts_attr in (("time(1 sec)", None),
                            ("externalTime(ets, 200)", "ets")):
        cwa = CompiledWindowedAgg(f"""
            define stream S (k int, ets long, v float);
            @info(name='q')
            from S#window.{window}
            select k, sum(v) as total group by k insert into Out;
        """, n_partitions=4, device="cpu")
        assert cwa.window_kind == "time" and cwa.ts_attr == ts_attr
        assert cwa.window == 64


def test_rejects_distinct_aggregate_args():
    with pytest.raises(SiddhiAppCreationError):
        CompiledWindowedAgg("""
            define stream S (k int, x float, y float);
            @info(name='q')
            from S#window.length(5)
            select k, sum(x) as sx, avg(y) as ay group by k
            insert into Out;
        """, n_partitions=4, device="cpu")


def test_cuda_device_without_cuda_raises(monkeypatch):
    """No silent CPU run: a CUDA engine with no CUDA is a RuntimeError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CompiledWindowedAgg(APP, n_partitions=4, device="cuda")
