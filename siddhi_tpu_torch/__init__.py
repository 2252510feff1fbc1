"""siddhi_tpu_torch — the PyTorch/CUDA port of siddhi_tpu.

Same public surface as the JAX package (``siddhi_tpu``): SiddhiQL apps
are parsed, analyzed and planned by the same host stack, and the query
shapes the port has a device path for run as PyTorch tensor programs plus
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).  The port
imports neither ``jax`` nor anything of ``siddhi_tpu``.

    from siddhi_tpu_torch import SiddhiManager, StreamCallback

    manager = SiddhiManager()              # device engine on "cuda"
    # manager = SiddhiManager(device="cpu")  # plain PyTorch versions
    runtime = manager.create_siddhi_app_runtime('''
        define stream S (sym string, price float);
        partition with (sym of S) begin
        from S[price > 10.0]#window.length(1000)
        select sym, sum(price) as s, count() as n group by sym
        insert into Out; end;
    ''')
    runtime.add_callback("Out", StreamCallback(print))
    runtime.start()
    runtime.get_input_handler("S").send_batch(
        {"sym": ["a", "b"], "price": [11.0, 12.0]})

Device paths ported so far: the keyed length-window aggregation
(plan/planner.DeviceWindowedAggRuntime on ops/windowed_agg + the CUDA
kernel csrc/wagg_length.cu).  Every other query shape runs on the host
engine, with the reason recorded in the query's ``backend_reason``.
"""

__version__ = "0.1.0"

from .analysis import AnalysisResult, Diagnostic, analyze
from .compiler import SiddhiCompiler
from .core.event import Event, EventChunk
from .core.profiling import (KernelProfiler, disable_profiling,
                             enable_profiling, profiler)
from .core.runtime import SiddhiAppRuntime, SiddhiManager
from .core.statistics import StatisticsManager, prometheus_text
from .core.tracing import Tracer, disable_tracing, enable_tracing, tracer
from .core.snapshot import (FileSystemPersistenceStore,
                            InMemoryPersistenceStore, PersistenceStore)
from .core.source_sink import InMemoryBroker
from .core.stream import (ColumnarStreamCallback, QueryCallback,
                          StreamCallback)
from .query_api import (Annotation, AttrType, Expression, Query, Selector,
                        SiddhiApp, StreamDefinition)

__all__ = [
    "SiddhiManager", "SiddhiAppRuntime", "SiddhiCompiler",
    "Event", "EventChunk", "StreamCallback", "ColumnarStreamCallback",
    "QueryCallback",
    "InMemoryBroker", "PersistenceStore", "InMemoryPersistenceStore",
    "FileSystemPersistenceStore",
    "SiddhiApp", "StreamDefinition", "Query", "Selector", "Expression",
    "Annotation", "AttrType",
    "StatisticsManager", "prometheus_text",
    "KernelProfiler", "profiler", "enable_profiling", "disable_profiling",
    "Tracer", "tracer", "enable_tracing", "disable_tracing",
    "analyze", "AnalysisResult", "Diagnostic",
]
