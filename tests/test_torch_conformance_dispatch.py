"""The JAX package's dispatch suites, run against the torch port.

Each suite file runs unchanged in a subprocess under the port, through
``tests/test_torch_conformance.py``'s plugin (``siddhi_tpu`` aliased to
``siddhi_tpu_torch``, the device engine on the CPU's plain steps); the
run must pass and import neither jax nor the JAX package.  One case a
suite: ``test_shards`` holds partition shard-out (routing pins, sharded
pattern / windowed-agg / grouped-agg rows against the unsharded ones,
shard-local growth, per-shard snapshots, SC005, the plan-IR and cost
surfaces, SA080); ``test_multitenant`` the cross-tenant packer (packed
rows against ``SIDDHI_TPU_XTENANT=0``, fewer dispatches, grow-and-replay
of one tenant, eviction, the cost model's packed bucket, the plan dump,
100 apps without a leak, quotas and their metrics).
"""
import pytest

from test_torch_conformance import run_suites

SUITES = ["tests/test_shards.py", "tests/test_multitenant.py"]

#: suite test id -> why the port skips it: only cases that call jax
SKIPS = {}


@pytest.mark.parametrize("suite", SUITES)
def test_dispatch_suite_passes_on_the_port(suite, tmp_path):
    out = run_suites(tmp_path, [suite], SKIPS, ["-m", "not slow"])
    n_skips = sum(k.startswith(suite + "::") for k in SKIPS)
    assert (f"{n_skips} skipped" in out) == bool(n_skips), out[-2000:]
