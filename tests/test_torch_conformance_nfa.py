"""The JAX package's NFA suites, run against the torch port.

Each suite file runs unchanged in a subprocess under the port, through
``tests/test_torch_conformance.py``'s plugin (``siddhi_tpu`` aliased to
``siddhi_tpu_torch``, the device engine and the pattern compilers on the
CPU's plain steps); the run must pass and import neither jax nor the JAX
package.  One case a suite: algebra (logical units, every forms,
counts), the engine's NFA surface, trailing `every`, string lanes,
telemetry, SEQUENCE, the B-event batching and integer-exact payloads.

Four suite cases are skipped: two call jax themselves and two need the
reference's 8-device virtual mesh.  Each has a torch copy below.
"""
import numpy as np
import pytest
import torch

from test_torch_conformance import run_suites

SUITES = ["tests/test_tpu_algebra.py", "tests/test_tpu_nfa.py",
          "tests/test_tpu_every_tail.py", "tests/test_tpu_strings.py",
          "tests/test_telemetry.py", "tests/test_sequence.py",
          "tests/test_nfa_batch.py", "tests/test_nfa_int_exact.py"]

_MESH = "needs the reference's 8-device virtual mesh (ROADMAP Queue 1 " \
    "item 5); a torch copy at mesh=None runs in test_torch_conformance_nfa"

#: suite test id -> why the port skips it
SKIPS = {
    "tests/test_tpu_nfa.py::test_sharded_step_runs_on_virtual_mesh":
        "imports jax to build the reference's virtual mesh",
    "tests/test_nfa_batch.py::test_jaxpr_tick_count_drops":
        "reads a jaxpr (jax.make_jaxpr); a torch copy counts the plain "
        "step's ticks in test_torch_conformance_nfa",
    "tests/test_nfa_batch.py::test_batched_matches_legacy_on_mesh": _MESH,
    "tests/test_telemetry.py::test_mesh_engine_bit_identical_with_telemetry":
        _MESH,
}


@pytest.mark.parametrize("suite", SUITES)
def test_nfa_suite_passes_on_the_port(suite, tmp_path):
    out = run_suites(tmp_path, [suite], SKIPS, ["-m", "not slow"])
    n_skips = sum(k.startswith(suite + "::") for k in SKIPS)
    assert (f"{n_skips} skipped" in out) == bool(n_skips), out[-2000:]


# ------------------------------------------------------------ torch copies

STREAM = "define stream S (price float, kind int);\n"
EVERY_WITHIN = ("from every e1=S[kind == 0] -> "
                "e2=S[kind == 1 and price > e1.price] within 3 sec "
                "select e1.price as p1, e2.price as p2 insert into Out;")


def _feed(n, parts, seed):
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, parts, n).astype(np.int64)
    cols = {"price": rng.uniform(0, 100, n).astype(np.float32),
            "kind": rng.integers(0, 3, n).astype(np.float32)}
    ts = 1_000_000 + np.cumsum(rng.integers(0, 900, n)).astype(np.int64)
    return pids, cols, ts


def test_plain_step_tick_count_drops(monkeypatch):
    """test_nfa_batch's tick count, on the port: with B = 4 and T = 10
    the plain step runs ceil(10 / 4) = 3 ticks of 4 events (the block
    padded to 12 with invalid rows); at B = 1 it runs all 10."""
    from siddhi_tpu_torch.ops import nfa as nfa_ops
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    nfa = CompiledPatternNFA(STREAM + EVERY_WITHIN, n_partitions=2,
                             mesh=None, batch_b=4, device="cpu")
    T = 10
    block = {a: torch.zeros((2, T)) for a in nfa.spec.attr_names}
    block["__ts"] = torch.arange(T, dtype=torch.int32)[None].repeat(2, 1)
    block["__stream"] = torch.zeros((2, T), dtype=torch.int32)
    block["__valid"] = torch.ones((2, T), dtype=torch.bool)
    _padded, t, ticks = nfa_ops._pad_block_t(block, 4)
    assert (t, ticks) == (T, 3)
    calls = []
    real = nfa_ops._one_event_step
    monkeypatch.setattr(nfa_ops, "_one_event_step",
                        lambda *a: calls.append(1) or real(*a))
    _c, outs = nfa_ops.build_block_step(nfa.spec)(nfa.carry, block)
    assert len(calls) == 3 * 4 and outs[0].shape[1] == T
    calls.clear()
    nfa_ops.build_block_step(nfa.spec, batch_b=1)(nfa.carry, block)
    assert len(calls) == T


def _run(nfa, feed):
    pids, cols, ts = feed
    return list(nfa.process_events(pids, cols, ts))


def test_batched_matches_legacy_unsharded():
    """test_nfa_batch's mesh case at mesh=None: B = 4 and B = 1 give the
    same rows over 8 partitions."""
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    app = STREAM + EVERY_WITHIN
    a = CompiledPatternNFA(app, n_partitions=8, batch_b=4, mesh=None,
                           device="cpu")
    b = CompiledPatternNFA(app, n_partitions=8, batch_b=1, mesh=None,
                           device="cpu")
    feed = _feed(300, 8, 0)
    got, want = _run(a, feed), _run(b, feed)
    assert got == want and len(want) > 0


def test_engine_bit_identical_with_telemetry_unsharded():
    """test_telemetry's mesh case at mesh=None: the telem leaf leaves the
    rows unchanged and reads back as [P, 3S + 1]."""
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    app = STREAM + EVERY_WITHIN
    telem = CompiledPatternNFA(app, n_partitions=8, telemetry=True,
                               mesh=None, device="cpu")
    plain = CompiledPatternNFA(app, n_partitions=8, mesh=None, device="cpu")
    feed = _feed(280, 8, 5)
    got, want = _run(telem, feed), _run(plain, feed)
    assert got == want and len(want) > 0
    tel = telem.last_telemetry
    assert tel is not None and tuple(tel.shape) == (8, 3 * 2 + 1)


def test_template_carry_matches_the_reference():
    """A parameterized compile (a pattern bank's template) holds the
    [P, ...] carry of its spec, as the reference's does: with telemetry
    its telem leaf is there."""
    from siddhi_tpu_torch.plan.nfa_compiler import CompiledPatternNFA
    from siddhi_tpu_torch.ops.nfa import make_carry
    app = ("define stream S (price float, kind int);\n"
           "from every e1=S[kind == 0 and price > 10.0] -> "
           "e2=S[kind == 1 and price > e1.price] within 9 sec "
           "select e1.price as p1 insert into Out;")
    nfa = CompiledPatternNFA(app, n_partitions=8, n_slots=4, mesh=None,
                             parameterize=True, telemetry=True,
                             device="cpu")
    want = make_carry(nfa.spec, 8)
    assert nfa.carry is not None and set(nfa.carry) == set(want)
    assert "telem" in nfa.carry
    for k, v in want.items():
        assert torch.equal(nfa.carry[k], v), k
