"""The JAX package's host suites, run against the torch port.

Each suite file runs unchanged in a subprocess under the port, through
``tests/test_torch_conformance.py``'s plugin (``siddhi_tpu`` aliased to
``siddhi_tpu_torch``, the device engine on the CPU's plain steps); the
run must pass and import neither jax nor the JAX package.  One case a
suite: partitions, tables, output and tables, named windows, rate
limits, functions, persistence, the flight recorder (its incident
bundle carries the compile row of a step's first call) and overload
control.
"""
import pytest

from test_torch_conformance import run_suites

SUITES = ["tests/test_partition.py", "tests/test_ref_tables.py",
          "tests/test_output_and_tables.py",
          "tests/test_ref_named_windows.py", "tests/test_ref_ratelimit.py",
          "tests/test_ref_functions.py", "tests/test_persistence.py",
          "tests/test_flight.py", "tests/test_overload.py"]


@pytest.mark.parametrize("suite", SUITES)
def test_host_suite_passes_on_the_port(suite, tmp_path):
    run_suites(tmp_path, [suite], {}, ["-m", "not slow"])
