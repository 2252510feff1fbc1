"""The JAX package's window suites, run against the torch port.

Each suite file runs unchanged in a subprocess under the port, through
``tests/test_torch_conformance.py``'s plugin (``siddhi_tpu`` aliased to
``siddhi_tpu_torch``, the device engine on the CPU's plain steps); the
run must pass and import neither jax nor the JAX package.  One case a
suite.  ``test_device_window`` holds the device window path (every kind
on ``backend == 'device'``) against the host processors;
``test_tpu_wagg`` the windowed aggregation, time windows included.
"""
import pytest

from test_torch_conformance import run_suites

SUITES = ["tests/test_device_window.py", "tests/test_ref_windows.py",
          "tests/test_hoping_window.py", "tests/test_windows.py",
          "tests/test_tpu_wagg.py"]

_JAX = "calls jax itself ({}); its torch copy is tests/{}"
_PALLAS = _JAX.format("Pallas in interpret mode",
                      "test_torch_wagg_kernel.py::"
                      "test_plain_equals_pallas_interpret")

#: suite test id -> why the port skips it: only cases that call jax
SKIPS = {
    "tests/test_tpu_wagg.py::test_wagg_pallas_interpret_matches_jnp":
        _PALLAS,
    "tests/test_tpu_wagg.py::test_wagg_minmax_matches_naive":
        _JAX.format("jax.jit", "test_torch_wagg_time.py::"
                    "test_wagg_minmax_matches_naive"),
    "tests/test_tpu_wagg.py::test_wagg_minmax_pallas_interpret_matches_jnp":
        _PALLAS,
    "tests/test_tpu_wagg.py::test_time_wagg_kernel_matches_naive":
        _JAX.format("jax.jit", "test_torch_wagg_time.py::"
                    "test_time_wagg_kernel_matches_naive"),
}


@pytest.mark.parametrize("suite", SUITES)
def test_window_suite_passes_on_the_port(suite, tmp_path):
    out = run_suites(tmp_path, [suite], SKIPS, ["-m", "not slow"])
    n_skips = sum(k.startswith(suite + "::") for k in SKIPS)
    assert (f"{n_skips} skipped" in out) == bool(n_skips), out[-2000:]
