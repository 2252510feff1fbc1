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
from siddhi_tpu_torch.ops.windowed_agg import (WaggCarry, make_wagg_carry,
                                               wagg_step, wagg_step_plain)

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
    carry = make_wagg_carry(P, W)
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
    carry = make_wagg_carry(8, 3)
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
