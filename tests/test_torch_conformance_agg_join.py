"""The JAX package's aggregation and join suites, run against the torch
port.

Each suite file runs unchanged in a subprocess under the port, through
``tests/test_torch_conformance.py``'s plugin (``siddhi_tpu`` aliased to
``siddhi_tpu_torch``, the device engine on the CPU's plain steps); the
run must pass and import neither jax nor the JAX package.  One case a
suite.  ``test_device_aggregation`` holds the slab runtime
(``DeviceAggregationRuntime``, K10's twin) against the host cascade;
``test_device_join_probe`` and ``test_join_lanes`` the device join probe
(K11's twin, ``backend == 'device'``) against the host mask;
``test_numguard`` the slab's compensated lanes and sentinels.
"""
import pytest

from test_torch_conformance import run_suites

SUITES = ["tests/test_device_aggregation.py",
          "tests/test_ref_aggregation.py",
          "tests/test_device_join_probe.py", "tests/test_join_lanes.py",
          "tests/test_join.py", "tests/test_ref_join_partition.py",
          "tests/test_ref_aggregators.py", "tests/test_numguard.py"]

_JAX = "calls jax itself ({}); its torch copy is tests/{}"

#: suite test id -> why the port skips it: only cases that call jax
SKIPS = {
    "tests/test_numguard.py::test_sentinel_plane_counts_flags":
        _JAX.format("jax.numpy", "test_torch_grouped_agg.py::"
                    "test_sentinel_plane_counts_flags"),
    "tests/test_numguard.py::test_sentinel_plane_all_clear":
        _JAX.format("jax.numpy", "test_torch_grouped_agg.py::"
                    "test_sentinel_plane_all_clear"),
}


@pytest.mark.parametrize("suite", SUITES)
def test_agg_join_suite_passes_on_the_port(suite, tmp_path):
    out = run_suites(tmp_path, [suite], SKIPS, ["-m", "not slow"])
    n_skips = sum(k.startswith(suite + "::") for k in SKIPS)
    assert (f"{n_skips} skipped" in out) == bool(n_skips), out[-2000:]
