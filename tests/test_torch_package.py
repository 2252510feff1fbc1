"""Package rules of the torch port.

- ``import siddhi_tpu_torch`` imports no jax (checked in a fresh
  interpreter), and no source file of the port or ``chip_smoke.py``
  imports jax or the JAX package;
- the default device is CUDA: without CUDA, building a keyed
  length-window runtime raises RuntimeError under 'auto' (no silent CPU
  run and no silent host run);
- device paths not yet ported fall back to the host under 'auto' with
  "not yet ported" in the recorded reason, and raise under 'device'
  (for patterns: a pattern outside the CUDA NFA kernel's class, on a
  CUDA device); the shapes ported since (filters, grouped and time-window
  aggregation, the join probe) build on the device engine under both;
- a registered step's first call writes a compile row to the flight
  ring and counts on its shape class.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import siddhi_tpu_torch
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.utils.errors import SiddhiAppCreationError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "siddhi_tpu_torch")


def _sources():
    for d, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            yield node.module


def test_import_pulls_in_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys, siddhi_tpu_torch\n"
            "from siddhi_tpu_torch.plan import planner, wagg_compiler\n"
            "from siddhi_tpu_torch.plan import gagg_compiler\n"
            "from siddhi_tpu_torch.plan import nfa_compiler\n"
            "from siddhi_tpu_torch.ops import windowed_agg, _kernels, nfa\n"
            "from siddhi_tpu_torch.ops import grouped_agg, select\n"
            "from siddhi_tpu_torch.ops import incremental_agg, join_probe\n"
            "from siddhi_tpu_torch.plan import iagg_compiler\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'siddhi_tpu' not in sys.modules, 'siddhi_tpu imported'\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path} imports {mod}"
        assert top != "siddhi_tpu", f"{path} imports {mod}"


WAGG_APP = """
@app:playback
define stream S (sym string, price float);
partition with (sym of S) begin
@info(name='q')
from S[price > 1.0]#window.length(4)
select sym, sum(price) as s, count() as n group by sym insert into Out;
end;
"""


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SiddhiManager().siddhi_context.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        SiddhiManager().create_siddhi_app_runtime(WAGG_APP)
    with pytest.raises(RuntimeError, match="cuda"):
        SiddhiManager().create_siddhi_app_runtime(
            "@app:engine('device')\n" + WAGG_APP)


def test_host_engine_needs_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt = SiddhiManager().create_siddhi_app_runtime(
        "@app:engine('host')\n" + WAGG_APP)
    try:
        assert not rt.partition_runtimes[0].device_mode
    finally:
        rt.shutdown()


UNPORTED = {
    # partitioned shapes: the partition runtime records the reason.  The
    # pattern shapes are SEQUENCEs, outside the CUDA NFA kernel's class:
    # refused on a CUDA device (on the CPU the plain step runs them)
    "partition_pattern": ("""
        define stream S (sym string, price float);
        partition with (sym of S) begin
        from every e1=S[price > 5.0], e2=S[price < e1.price]
        select e1.sym as a, e2.price as p insert into Out; end;""", True),
    # unpartitioned shapes: the query runtime records the reason
    "pattern": ("""
        define stream S (sym string, price float);
        from every e1=S[price > 5.0], e2=S[price < e1.price]
        select e1.sym as a insert into Out;""", False),
}

#: shapes that were in UNPORTED until the grouped-aggregation, filter,
#: time-window aggregation (K6) runtimes and the join probe (K11) were
#: ported: each now builds on the device engine (a join: its buffers on
#: the host, its probe on the device)
PORTED = {
    "join": ("""
        define stream S (sym string, price float);
        define stream R (sym string, v float);
        from S#window.length(3) join R#window.length(3)
        on S.sym == R.sym select S.sym as a, R.v as v insert into Out;""",
             False, "JoinRuntime"),
    "partition_time_window": ("""
        define stream S (sym string, price float);
        partition with (sym of S) begin
        from S#window.time(1 sec)
        select sym, sum(price) as s group by sym insert into Out; end;""",
                              True, "DeviceWindowedAggRuntime"),
    "filter": ("""
        define stream S (sym string, price float);
        from S[price > 5.0] select sym, price insert into Out;""", False,
               "DeviceFilterRuntime"),
    "window_aggregate": ("""
        define stream S (sym string, price float);
        from S#window.length(3)
        select sym, sum(price) as s group by sym insert into Out;""", False,
                         "DeviceGroupedAggRuntime"),
}


def _manager(name, monkeypatch):
    """The pattern shapes build on a CUDA device (torch.cuda reported
    available: the refusal comes before any device memory is touched);
    the others on the CPU."""
    if "pattern" in name:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        return SiddhiManager(device="cuda")
    return SiddhiManager(device="cpu")


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_kind_falls_back_under_auto(name, monkeypatch):
    text, partitioned = UNPORTED[name]
    rt = _manager(name, monkeypatch).create_siddhi_app_runtime(text)
    try:
        if partitioned:
            pr = rt.partition_runtimes[0]
            assert not pr.device_mode
            reason = pr.fallback_reason
        else:
            (qr,) = rt.query_runtimes.values()
            assert qr.backend == "host"
            reason = qr.backend_reason
        assert "not yet ported" in reason
    finally:
        rt.shutdown()


@pytest.mark.parametrize("name", ["partition_pattern", "pattern"])
def test_unported_kind_raises_under_device(name, monkeypatch):
    text, _ = UNPORTED[name]
    with pytest.raises(SiddhiAppCreationError, match="not yet ported"):
        _manager(name, monkeypatch).create_siddhi_app_runtime(
            "@app:engine('device')\n" + text)


@pytest.mark.parametrize("engine", ["auto", "device"])
@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_kind_builds_on_device(name, engine):
    text, partitioned, runtime = PORTED[name]
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        f"@app:engine('{engine}')\n" + text)
    try:
        if partitioned:
            pr = rt.partition_runtimes[0]
            assert pr.device_mode, pr.fallback_reason
            (qr,) = pr.device_query_runtimes.values()
        else:
            (qr,) = rt.query_runtimes.values()
        assert qr.backend == "device", qr.backend_reason
        if qr.join_runtime is not None:
            assert qr.join_runtime.device_probe is not None
            assert type(qr.join_runtime).__name__ == runtime
        else:
            assert type(qr.device_runtime).__name__ == runtime
    finally:
        rt.shutdown()


STRING_FILTER_APP = WAGG_APP.replace("S[price > 1.0]",
                                     "S[sym != 'x' and price > 1.0]")


def test_expression_rejection_falls_back_under_auto():
    """A filter over a string attribute (no device lane) is the length-
    window program's own rejection (SiddhiAppCreationError), never a
    crash: the keyed fallback hands the query to the grouped-agg step,
    whose filters run host-side, so the partition stays on the device
    engine under 'auto' and under 'device' (as in the JAX package)."""
    import numpy as np
    from siddhi_tpu_torch.plan.wagg_compiler import CompiledWindowedAgg
    cwa = CompiledWindowedAgg("""
        define stream S (sym string, price float);
        @info(name='q')
        from S[sym != 'x' and price > 1.0]#window.length(4)
        select sym, sum(price) as s group by sym insert into Out;""",
                              n_partitions=2, device="cpu")
    block = {"price": np.ones((2, 1), np.float32),
             "__ts": np.zeros((2, 1), np.int32),
             "__valid": np.ones((2, 1), bool)}
    with pytest.raises(SiddhiAppCreationError,
                       match="expression rejected.*KeyError"):
        cwa.process_block(block)

    for head in ("", "@app:engine('device')\n"):
        rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
            head + STRING_FILTER_APP)
        try:
            pr = rt.partition_runtimes[0]
            assert pr.device_mode, pr.fallback_reason
            assert type(pr.device_query_runtimes["q"].device_runtime) \
                .__name__ == "DeviceGroupedAggRuntime"
        finally:
            rt.shutdown()


@pytest.mark.parametrize("where", ["to_device", "step", "program_launch"])
def test_device_failure_is_not_a_fallback(where, monkeypatch):
    """A failed copy, allocation or launch while the runtime is built
    propagates under 'auto': it never turns into a host run."""
    from siddhi_tpu_torch.plan import wagg_compiler

    def fail(*_a, **_k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    if where == "to_device":
        monkeypatch.setattr(wagg_compiler.CompiledWindowedAgg, "to_device",
                            fail)
    elif where == "step":
        monkeypatch.setattr(wagg_compiler, "wagg_step", fail)
    else:
        # a launch inside the filter program: its mask combine
        monkeypatch.setattr(torch.Tensor, "__and__", fail)
    with pytest.raises(RuntimeError, match="simulated"):
        SiddhiManager(device="cpu").create_siddhi_app_runtime(WAGG_APP)


def test_shard_out_not_yet_ported(monkeypatch):
    monkeypatch.setenv("SIDDHI_TPU_SHARDS", "2")
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(WAGG_APP)
    try:
        pr = rt.partition_runtimes[0]
        assert not pr.device_mode
        assert "not yet ported" in pr.fallback_reason
    finally:
        rt.shutdown()


def test_plan_verify_records_jaxpr_pass_as_skipped():
    from siddhi_tpu_torch.analysis.plan_verify import attach_plan_analysis
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(WAGG_APP)
    try:
        rep = attach_plan_analysis(rt, jaxpr=True)
        assert rep.skipped and "not run under torch" in rep.skipped[0]
        assert rt.partition_runtimes[0].device_mode
    finally:
        rt.shutdown()


FLIGHT_APP = """
@app:name('compilerow')
@app:statistics(reporter='console', interval='300', telemetry='true')
define stream S (sym string, price float);
@info(name='q')
from every e1=S[price > 10.0] -> e2=S[price > e1.price]
select e1.price as p1, e2.price as p2 insert into Out;
"""


def test_first_call_writes_compile_row(tmp_path, monkeypatch):
    """The port's counterpart of an XLA compile: a step's first call is
    timed, counted on its shape class and written to the flight ring,
    so an on-demand bundle carries a "compile" row, as the JAX
    package's does."""
    from siddhi_tpu_torch.core.flight import DIR_ENV, flight
    from siddhi_tpu_torch.plan.shapes import shape_registry
    monkeypatch.setenv(DIR_ENV, str(tmp_path))
    before = shape_registry().totals()["compiles"]
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(FLIGHT_APP)
    try:
        rt.start()
        h = rt.get_input_handler("S")
        for p in (12.0, 15.0, 11.0, 20.0):
            h.send(["A", p])
        rt.flush()
        bundle = flight().emit("on_demand", app="compilerow", runtime=rt)
        rows = [r for r in bundle["ring"] if "compile" in r]
        assert rows and rows[-1]["kernel"].startswith("nfa.")
        assert rows[-1]["blocked_s"] >= 0.0
        totals = shape_registry().totals()
        assert totals["compiles"] > before
        entry = next(e for e in shape_registry().snapshot()["entries"]
                     if e["signature"] == rows[-1]["compile"])
        assert entry["compiles"] >= 1 and entry["last_compile_unix"] > 0
        assert entry["compile_seconds"] >= 0.0 and entry["calls"] >= 1
    finally:
        rt.shutdown()


def test_public_surface():
    for name in ("SiddhiManager", "StreamCallback", "ColumnarStreamCallback",
                 "InMemoryPersistenceStore"):
        assert hasattr(siddhi_tpu_torch, name)
