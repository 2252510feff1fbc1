"""The JAX package's pattern suites, run against the torch port.

Each suite file runs unchanged in a subprocess under the port, through
``tests/test_torch_conformance.py``'s plugin (``siddhi_tpu`` aliased to
``siddhi_tpu_torch``, the device engine on the CPU's plain steps); the
run must pass and import neither jax nor the JAX package.  One case a
suite, so a failure names its suite.  ``test_planner`` includes the
``#window.lengthBatch`` query that runs on the device window path.
"""
import pytest

from test_torch_conformance import run_suites

SUITES = ["tests/test_planner.py", "tests/test_pattern.py",
          "tests/test_ref_pattern_absent.py",
          "tests/test_ref_pattern_count_within.py",
          "tests/test_ref_pattern_every_logical.py",
          "tests/test_ref_sequence.py", "tests/test_nfa_every_fork.py",
          "tests/test_seq_leading_kleene.py",
          "tests/test_absent_boundary_stress.py"]

#: suite test id -> why the port skips it (none: every case passes)
SKIPS = {}


@pytest.mark.parametrize("suite", SUITES)
def test_pattern_suite_passes_on_the_port(suite, tmp_path):
    run_suites(tmp_path, [suite], SKIPS, ["-m", "not slow"])
