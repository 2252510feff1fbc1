"""The JAX package's own suites for filters, grouped aggregation and the
selection tail, run against the torch port.

A subprocess runs the suite files unchanged under pytest with
``--noconftest`` (``tests/conftest.py`` imports jax and the JAX package)
and a plugin, written to a temporary directory, that installs before
collection:

  - an import hook mapping the name ``siddhi_tpu`` (and every
    ``siddhi_tpu.<module>``) onto ``siddhi_tpu_torch``;
  - ``SiddhiManager``, ``CompiledWindowedAgg``, ``CompiledPatternNFA``
    and ``CompiledPatternBank`` defaulting to ``device="cpu"`` (the
    port's default is the card), so the device engine runs the plain
    PyTorch steps.

The run must pass, and must not have imported jax.  A suite test the
port cannot pass stays in ``SKIPS`` with its reason (ROADMAP Queue 3
lists each).  ``tests/test_torch_conformance_*.py`` run further suite
groups through :func:`run_suites`, one file a group so that ``--dist
loadfile`` spreads them over workers.
"""
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUITES = ["tests/test_device_grouped_agg.py", "tests/test_select_device.py",
          "tests/test_filter.py", "tests/test_ref_filter.py",
          "tests/test_ref_misc_filters.py"]

#: suite test id -> why the port skips it
SKIPS = {}

PLUGIN = textwrap.dedent('''
    """pytest plugin: run the JAX package's suites against the port."""
    import importlib
    import importlib.abc
    import importlib.util
    import json
    import sys

    import pytest


    class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
        """siddhi_tpu[.x] -> the imported siddhi_tpu_torch[.x] module
        itself (its own __spec__ kept, so its relative imports hold)."""

        def find_spec(self, name, path=None, target=None):
            if name == "siddhi_tpu" or name.startswith("siddhi_tpu."):
                real = "siddhi_tpu_torch" + name[len("siddhi_tpu"):]
                return importlib.util.spec_from_loader(name, self,
                                                       origin=real)
            return None

        def create_module(self, spec):
            module = importlib.import_module(spec.origin)
            self.real_spec = module.__spec__
            return module

        def exec_module(self, module):
            module.__spec__ = self.real_spec


    sys.meta_path.insert(0, _Alias())

    import siddhi_tpu_torch  # noqa: E402

    _init = siddhi_tpu_torch.SiddhiManager.__init__


    def _cpu_default(self, device="cpu"):
        _init(self, device=device)


    siddhi_tpu_torch.SiddhiManager.__init__ = _cpu_default

    import siddhi_tpu_torch.plan.wagg_compiler as _wc  # noqa: E402

    _cwa_init = _wc.CompiledWindowedAgg.__init__


    def _cwa_cpu_default(self, *a, device="cpu", **k):
        _cwa_init(self, *a, device=device, **k)


    _wc.CompiledWindowedAgg.__init__ = _cwa_cpu_default

    import siddhi_tpu_torch.plan.nfa_compiler as _nc  # noqa: E402


    def _cpu_compiler(cls):
        init = cls.__init__

        def _init_cpu(self, *a, device=None, **k):
            init(self, *a, device="cpu" if device is None else device, **k)
        cls.__init__ = _init_cpu


    _cpu_compiler(_nc.CompiledPatternNFA)
    _cpu_compiler(_nc.CompiledPatternBank)
    SKIPS = json.loads(%r)
    OUT = %r


    def pytest_configure(config):
        config.addinivalue_line("markers", "slow: long-running soak")


    def pytest_collection_modifyitems(session, config, items):
        for item in items:
            reason = SKIPS.get(item.nodeid)
            if reason is not None:
                item.add_marker(pytest.mark.skip(reason=reason))


    def pytest_sessionfinish(session, exitstatus):
        with open(OUT, "w") as f:
            json.dump({"jax": "jax" in sys.modules,
                       "reference": any(
                           getattr(m, "__name__", "") == "siddhi_tpu"
                           for m in list(sys.modules.values())),
                       "exit": int(exitstatus)}, f)
''')


def run_suites(tmp_path, suites, skips, extra_args=()):
    """Run the suite files under the port (see the module docstring) in
    one subprocess; assert it passed and imported neither jax nor the
    JAX package.  Returns pytest's output."""
    out = tmp_path / "session.json"
    (tmp_path / "port_as_reference.py").write_text(
        PLUGIN % (json.dumps(skips), str(out)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest",
         "-p", "port_as_reference", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist", "-o", "addopts=",
         "--rootdir", ROOT] + list(extra_args) + list(suites),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = (r.stdout + r.stderr)[-6000:]
    assert r.returncode == 0, tail
    session = json.loads(out.read_text())
    assert session == {"jax": False, "reference": False, "exit": 0}, tail
    assert " passed" in r.stdout, tail
    return r.stdout


def test_reference_suites_pass_on_the_port(tmp_path):
    run_suites(tmp_path, SUITES, SKIPS)
