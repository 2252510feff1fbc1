"""The join probe (K11): JAX package vs torch port.

- ``probe_compact_plain`` against the JAX package's compaction
  (``jnp.nonzero(size=cap, fill_value=-1)`` and an int32 sum over the
  mask AND the valid rows and columns), cap below the count included.
- The public API: the same join app through both packages' default
  engines (the port's ``device="cpu"``: the condition as a torch program,
  the twin's compaction), both with ``backend == 'device'``, rows equal
  in order: a range join, string and double lanes, an outer join,
  right-side arrivals, a run that grows the cap past 4096, a probe past
  the int32 cell limit (cut small) in row blocks.
- Without CUDA the port's default device raises for a device-probe join.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.ops.join_probe import probe_compact, \
    probe_compact_plain


def _jax_compact(mask, nl, nr, cap):
    nl2, nr2 = mask.shape
    m = jnp.asarray(mask) & jnp.asarray(np.arange(nl2) < nl)[:, None] \
        & jnp.asarray(np.arange(nr2) < nr)[None, :]
    flat = m.reshape(-1)
    (idx,) = jnp.nonzero(flat, size=cap, fill_value=-1)
    return (np.asarray(idx.astype(jnp.int32)),
            np.asarray(jnp.sum(flat.astype(jnp.int32))))


@pytest.mark.parametrize("nl2,nr2,nl,nr,density,cap", [
    (1, 1, 1, 1, 1.0, 4), (1, 1, 0, 1, 1.0, 4), (4, 8, 3, 5, 0.0, 16),
    (8, 8, 8, 8, 1.0, 64), (16, 32, 11, 29, 0.5, 8),
    (64, 128, 50, 100, 0.3, 4096), (128, 64, 127, 63, 0.05, 3),
    (256, 256, 200, 250, 0.7, 0)])
def test_probe_compact_plain_equals_jax(nl2, nr2, nl, nr, density, cap):
    rng = np.random.default_rng(nl2 * 7 + nr2)
    mask = rng.random((nl2, nr2)) < density
    want_idx, want_n = _jax_compact(mask, nl, nr, cap)
    for t in (torch.from_numpy(mask), torch.from_numpy(mask).to(
            torch.uint8)):
        idx, n = probe_compact_plain(t, nl, nr, cap)
        assert idx.dtype == torch.int32 and n.dtype == torch.int32
        assert np.array_equal(idx.numpy(), want_idx)
        assert int(n) == int(want_n)
        idx2, n2 = probe_compact(t, nl, nr, cap)   # CPU: the twin
        assert torch.equal(idx2, idx) and int(n2) == int(n)


def test_probe_compact_rejects_bad_bounds():
    with pytest.raises(ValueError, match="outside"):
        probe_compact_plain(torch.ones((2, 2), dtype=torch.bool), 3, 1, 4)


# ------------------------------------------------------------ public API

STREAMS = """
define stream L (id int, price float, sym string, d double);
define stream R (id int, threshold float, sym string, d double);
"""

APPS = {
    "range": """
        @info(name='q')
        from L#window.length(6) join R#window.length(6)
            on L.price > R.threshold and L.id == R.id
        select L.id as lid, L.price as p, R.threshold as t
        insert into Out;""",
    "string_and_double_lanes": """
        @info(name='q')
        from L#window.length(5) join R#window.length(5)
            on L.sym == R.sym and L.d < R.d
        select L.id as lid, R.id as rid, L.sym as s
        insert into Out;""",
    "left_outer": """
        @info(name='q')
        from L#window.length(4) left outer join R#window.length(4)
            on L.price > R.threshold
        select L.id as lid, R.id as rid insert into Out;""",
    "right_arrivals": """
        @info(name='q')
        from L#window.length(8) join R
            on L.price < R.threshold and L.sym != R.sym
        select L.id as lid, R.id as rid, R.threshold as t
        insert into Out;""",
}


def _sends(seed, n=60):
    rng = np.random.default_rng(seed)
    out, t = [], 1_000_000
    syms = ["a", "b", "c"]
    for _ in range(n):
        sid = "L" if rng.integers(0, 2) else "R"
        out.append((sid, [int(rng.integers(0, 4)),
                          float(np.float32(rng.uniform(0, 100))),
                          syms[int(rng.integers(0, 3))],
                          float(rng.uniform(0, 1))], t))
        t += 100
    return out


def _run(pkg, app, sends):
    m = (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
         else pkg.SiddhiManager())
    rt = m.create_siddhi_app_runtime("@app:playback " + app)
    out = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: out.extend((e.timestamp, tuple(e.data)) for e in evs)))
    rt.start()
    try:
        for sid, row, ts in sends:
            rt.get_input_handler(sid).send(row, timestamp=ts)
        qr = rt.query_runtimes["q"]
        return qr.backend, qr.backend_reason, out
    finally:
        rt.shutdown()


@pytest.mark.parametrize("name", sorted(APPS))
def test_join_rows_equal_jax(name):
    app = STREAMS + APPS[name]
    sends = _sends(len(name))
    jb, jr, want = _run(siddhi_tpu, app, sends)
    tb, tr, got = _run(siddhi_tpu_torch, app, sends)
    assert jb == "device", jr
    assert tb == "device", tr
    assert want and got == want


WIDE_APP = STREAMS + """
    @info(name='q')
    from L#window.length(100) join R#window.length(100)
        on L.price > R.threshold
    select L.id as lid, R.id as rid insert into Out;"""


def _wide_batches():
    rng = np.random.default_rng(3)
    right = {"id": np.arange(100, dtype=np.int64),
             "threshold": rng.uniform(0, 10, 100).astype(np.float32),
             "sym": np.full(100, "a", object), "d": np.zeros(100)}
    left = {"id": np.arange(64, dtype=np.int64),
            "price": rng.uniform(5, 100, 64).astype(np.float32),
            "sym": np.full(64, "a", object), "d": np.zeros(64)}
    return right, left


def _run_batches(pkg, batches, on_start=None):
    """Send each (stream, columns) batch in order through WIDE_APP; the
    rows out and the query's join runtime."""
    m = (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
         else pkg.SiddhiManager())
    rt = m.create_siddhi_app_runtime("@app:playback " + WIDE_APP)
    out = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: out.extend(tuple(e.data) for e in evs)))
    rt.start()
    try:
        qr = rt.query_runtimes["q"]
        if on_start is not None:
            on_start(qr.join_runtime)
        for k, (sid, cols) in enumerate(batches):
            n = len(cols["id"])
            rt.get_input_handler(sid).send_batch(
                cols, timestamps=np.full(n, 1_000_000 + 100 * k, np.int64))
        assert qr.backend == "device", qr.backend_reason
        return out, qr.join_runtime
    finally:
        rt.shutdown()


def test_cap_grows_past_4096_equal_jax():
    """A chunk whose matches pass the starting cap (64 arrivals against
    100 buffered rows, ~6,000 pairs): the count is read, the cap doubles
    to 8192, the probe runs again; rows as JAX's, in order."""
    right, left = _wide_batches()
    batches = [("R", right), ("L", left)]
    want, jj = _run_batches(siddhi_tpu, batches)
    got, tj = _run_batches(siddhi_tpu_torch, batches)
    assert jj._probe_cap == 8192 and tj._probe_cap == 8192
    assert len(want) > 4096 and got == want


@pytest.mark.parametrize("arriving", ["left", "right"])
def test_probe_past_int32_cells_runs_in_row_blocks(monkeypatch, arriving):
    """A probe of more cells than int32 flat indices address runs in
    blocks of rows, each block's indices offset on the host: with the
    limit cut to 1,000 cells, the [64, 128] probe runs as 16 blocks of 4
    rows, and the rows equal JAX's single probe in order, for arrivals
    on either side."""
    import siddhi_tpu_torch.ops.join_probe as jp
    right, left = _wide_batches()
    batches = ([("R", right), ("L", left)] if arriving == "left"
               else [("L", left), ("R", right)])
    want, _ = _run_batches(siddhi_tpu, batches)
    monkeypatch.setattr(jp, "MAX_CELLS", 1000)
    shapes = []

    def spy(jr):
        jit = jr._probe_jit

        def probe(lcols, rcols, nl, nr, nl2, nr2, cap):
            shapes.append((nl2, nr2))
            return jit(lcols, rcols, nl, nr, nl2, nr2, cap)
        jr._probe_jit = probe

    got, _ = _run_batches(siddhi_tpu_torch, batches, spy)
    assert (4, 128) in shapes and all(a * b <= 1000 for a, b in shapes)
    assert len(want) > 4096 and got == want


def test_probe_row_past_int32_cells_raises(monkeypatch):
    """One opposite buffer wider than int32 flat indices address (the
    limit cut to 100 cells, 128 columns) raises, through the stream's
    error route, and emits nothing; it does not move to the host."""
    import siddhi_tpu_torch.ops.join_probe as jp
    right, left = _wide_batches()
    monkeypatch.setattr(jp, "MAX_CELLS", 100)
    errors = []
    out, _ = _run_batches(
        siddhi_tpu_torch, [("R", right), ("L", left)],
        lambda jr: jr.qr.app_runtime.app_ctx.exception_listeners.append(
            errors.append))
    assert out == []
    assert [type(e) for e in errors] == [ValueError]
    assert "one probe row" in str(errors[0])


def test_without_cuda_a_device_probe_join_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        siddhi_tpu_torch.SiddhiManager().create_siddhi_app_runtime(
            STREAMS + APPS["range"])
