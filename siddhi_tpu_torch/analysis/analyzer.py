"""Multi-pass semantic analyzer: SiddhiQL app → typed diagnostics.

Runs between parse and plan.  Takes app text or an already-built
query_api :class:`~siddhi_tpu_torch.query_api.SiddhiApp` and produces an
:class:`AnalysisResult` — a list of :class:`Diagnostic` objects with
stable codes, severities and source spans (threaded from the tokenizer
through query_api.position).

Passes, in order, per execution element:

  1. name resolution + expression type inference/checking (scope.py,
     typecheck.py) — SA001..SA008
  2. unbounded-state detection (passes.state_pass) — SA020..SA022
  3. partition safety (passes.partition_pass) — SA030/SA031
  4. retrace-hazard / host-fallback / precision prediction
     (passes.perf_pass) — SP001..SP012
  5. app-wide dead code (passes.deadcode_pass) — SA040/SA041

Deliberately imports no jax and never builds a runtime: analyzing a
broken app is free and safe.  The runtime integration lives in
core/runtime.py (``strict=`` on create_siddhi_app_runtime); the CLI in
siddhi_tpu_torch/analyze.py.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Set, Union

from ..query_api import (Partition, Query, SiddhiApp, find_annotation)
from ..query_api.definition import (AbstractDefinition, Attribute, AttrType,
                                    StreamDefinition)
from ..query_api.expression import Constant, TimeConstant, Variable
from ..query_api.position import SourcePos, pos_of
from ..query_api.query import (DeleteStream, Filter, JoinInputStream,
                               RangePartitionType, ReturnStream,
                               SingleInputStream, StreamFunctionHandler,
                               UpdateOrInsertStream, UpdateStream,
                               ValuePartitionType, WindowHandler)
from .diagnostics import Diagnostic, DiagnosticSink, Severity
from .passes import (_single_streams, deadcode_pass, partition_pass,
                     perf_pass, shard_pass, state_pass)
from .scope import QueryScope, SymbolTable, scope_for_input
from .typecheck import TypeChecker

# window name → parameter positions that must be compile-time constants
# (other windows/positions legitimately take attribute references, e.g.
# externalTime's first argument)
_CONST_PARAM_POSITIONS = {
    "length": (0,), "lengthbatch": (0,), "time": (0,), "timebatch": (0,),
    "timelength": (0, 1), "hopping": (0, 1), "delay": (0,),
    "externaltime": (1,), "externaltimebatch": (1,), "session": (0,),
}

_NUMERIC = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)


@dataclass
class AnalysisResult:
    diagnostics: List[Diagnostic] = field(default_factory=list)
    app_name: Optional[str] = None
    #: PlanReport from the plan-level verifier (plan_verify.py) — set by
    #: attach_plan_analysis after the runtime is built; None when only
    #: source-level analysis ran (e.g. the default CLI path)
    plan: Optional[object] = None
    #: StateSchemaReport from the persistent-state schema extractor
    #: (state_schema.py) — set by attach_schema_analysis when the
    #: runtime is built; None for source-only analysis
    schema: Optional[object] = None
    #: NumericReport from the numeric-safety verifier (ranges.py) — the
    #: source-level pass sets it at analyze() time; when a runtime is
    #: built, attach_numeric_analysis replaces it with the plan-grounded
    #: refinement
    numeric: Optional[object] = None

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    @property
    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.INFO]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> Set[str]:
        return {d.code for d in self.diagnostics}

    def as_dicts(self) -> List[dict]:
        return [d.as_dict() for d in self.diagnostics]

    def render(self, filename: str = "<app>") -> str:
        if not self.diagnostics:
            return f"{filename}: no diagnostics"
        lines = [d.render(filename) for d in self.diagnostics]
        lines.append(
            f"{len(self.errors)} error(s), {len(self.warnings)} "
            f"warning(s), {len(self.infos)} info(s)")
        return "\n".join(lines)

    def raise_if(self, strict: bool = False) -> None:
        """Raise SiddhiAppValidationException on errors — and, under
        strict, on warnings too."""
        from ..utils.errors import SiddhiAppValidationException
        bad = self.errors + (self.warnings if strict else [])
        if bad:
            raise SiddhiAppValidationException(
                f"semantic analysis found {len(bad)} problem(s):\n" +
                "\n".join("  " + d.render() for d in bad))


def _engine_mode(app: SiddhiApp) -> str:
    ann = find_annotation(app.annotations, "app:engine") or \
        find_annotation(app.annotations, "engine")
    if ann is not None:
        pos = ann.positional()
        mode = str(pos[0] if pos else ann.get("mode", "auto")).lower()
    else:
        mode = os.environ.get("SIDDHI_TPU_ENGINE", "auto").lower()
    return mode if mode in ("auto", "device", "host") else "auto"


# ==================================================================== entry

def analyze(app: Union[str, SiddhiApp],
            engine: Optional[str] = None) -> AnalysisResult:
    """Analyze an app (SiddhiQL text or query_api object model).

    ``engine`` overrides the device/host/auto mode used by the SP0xx
    performance passes (default: the app's @app:engine annotation /
    SIDDHI_TPU_ENGINE env, like the planner)."""
    sink = DiagnosticSink()
    if isinstance(app, str):
        from ..compiler import SiddhiCompiler
        from ..utils.errors import SiddhiParserException
        try:
            app = SiddhiCompiler.parse(app)
        except SiddhiParserException as e:
            pos = (SourcePos(e.line, e.col) if e.line >= 0 else None)
            sink.emit("SA000", str(e), pos=pos)
            return AnalysisResult(sink.diagnostics)
    res = AnalysisResult(app_name=app.name)
    engine = engine or _engine_mode(app)
    table = SymbolTable(app)
    insert_targets: Set[str] = set()

    _analyze_aggregations(table, sink)

    qidx = 0
    for el in app.execution_elements:
        if isinstance(el, Query):
            _analyze_query(table, el, el.name or f"query_{qidx}", sink,
                           engine, insert_targets, partition=None)
        else:
            _analyze_partition(table, el, qidx, sink, engine,
                               insert_targets)
        qidx += 1

    deadcode_pass(table, insert_targets, sink)
    _fault_tolerance_pass(app, sink)
    _ingest_protection_pass(app, sink)
    _slo_pass(app, sink)
    from .ranges import numeric_pass
    res.numeric = numeric_pass(app, sink, engine)
    order = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}
    res.diagnostics = sorted(
        sink.diagnostics,
        key=lambda d: (order[d.severity],
                       d.line if d.line >= 0 else 1 << 30, d.code))
    return res


# ========================================================= fault tolerance

_ONERROR_ACTIONS = {"LOG", "STREAM", "STORE", "WAIT"}


def _fault_tolerance_pass(app: SiddhiApp, sink: DiagnosticSink) -> None:
    """SA050/SA051: @OnError configuration hazards (core/resilience.py).

    STORE routes failed events into the runtime's error store; without
    one configured — `@app:errorStore(...)` on the app (or
    `SiddhiManager.set_error_store`, invisible to static analysis, hence
    a warning not an error) — those events degrade to LOG and are
    lost."""
    has_app_store = (
        find_annotation(app.annotations, "app:errorstore") is not None
        or find_annotation(app.annotations, "errorstore") is not None)
    for sid, d in app.stream_definitions.items():
        on_err = find_annotation(d.annotations, "onerror")
        if on_err is None:
            continue
        action = (on_err.get("action", "LOG") or "LOG").upper()
        if action not in _ONERROR_ACTIONS:
            sink.emit("SA051",
                      f"stream '{sid}': @OnError action '{action}' is not "
                      f"one of LOG/STREAM/STORE/WAIT; it will fall back "
                      f"to LOG", pos=pos_of(d))
        elif action == "STORE" and not has_app_store:
            sink.emit("SA050",
                      f"stream '{sid}' uses @OnError(action='STORE') but "
                      f"the app configures no error store; failed events "
                      f"will be logged and lost", pos=pos_of(d))


# ====================================================== ingest protection

_OVERLOAD_POLICIES = {"BLOCK", "SHED_OLDEST", "SHED_NEW", "STORE"}


def _ingest_protection_pass(app: SiddhiApp, sink: DiagnosticSink) -> None:
    """SA060-SA063: overload/quarantine annotation hazards
    (core/overload.py).  The runtime never crashes on bad config — it
    clamps to defaults with a log warning — so these diagnostics are the
    only place the author learns the option was ignored."""
    has_app_store = (
        find_annotation(app.annotations, "app:errorstore") is not None
        or find_annotation(app.annotations, "errorstore") is not None)

    def num(ann, key):
        raw = ann.get(key, None)
        if raw is None:
            return None, False
        try:
            return float(raw), False
        except (TypeError, ValueError):
            return None, True

    for sid, d in app.stream_definitions.items():
        a = find_annotation(d.annotations, "async")
        if a is not None:
            policy = a.get("overload", None)
            if policy is not None \
                    and policy.upper() not in _OVERLOAD_POLICIES:
                sink.emit("SA060",
                          f"stream '{sid}': @Async overload policy "
                          f"'{policy}' is not one of BLOCK/SHED_OLDEST/"
                          f"SHED_NEW/STORE; it will fall back to BLOCK",
                          pos=pos_of(d))
            elif policy is not None and policy.upper() == "STORE" \
                    and not has_app_store:
                sink.emit("SA062",
                          f"stream '{sid}' uses @Async(overload='STORE') "
                          f"but the app configures no error store; above "
                          f"the high watermark admission degrades to "
                          f"bounded BLOCK", pos=pos_of(d))
            high, bad_h = num(a, "overload.high")
            low, bad_l = num(a, "overload.low")
            bt, bad_bt = num(a, "block.timeout.ms")
            dt, bad_dt = num(a, "drain.timeout.ms")
            bad = bad_h or bad_l or bad_bt or bad_dt
            if not bad:
                h = high if high is not None else 0.8
                lo = low if low is not None else 0.5
                bad = (not (0.0 < h <= 1.0) or not (0.0 <= lo <= 1.0)
                       or lo >= h
                       or (bt is not None and bt <= 0)
                       or (dt is not None and dt <= 0))
            if bad:
                sink.emit("SA061",
                          f"stream '{sid}': @Async overload options are "
                          f"invalid (need 0 < overload.low < "
                          f"overload.high <= 1 and positive timeouts); "
                          f"the runtime will clamp them to defaults",
                          pos=pos_of(d))
        q = find_annotation(d.annotations, "quarantine")
        if q is not None:
            bad = False
            raw = q.get("ts.slack.ms", None)
            if raw is not None:
                try:
                    if int(raw) < 0:
                        bad = True
                except (TypeError, ValueError):
                    bad = True
            for key in ("nan", "wrap"):
                v = q.get(key, None)
                if v is not None and str(v).strip().lower() not in (
                        "1", "true", "on", "yes", "0", "false", "off",
                        "no"):
                    bad = True
            if bad:
                sink.emit("SA063",
                          f"stream '{sid}': @quarantine options are "
                          f"malformed (ts.slack.ms must be a "
                          f"non-negative integer, nan/wrap booleans); "
                          f"the runtime will fall back to the option's "
                          f"default", pos=pos_of(d))


# ============================================== service-level objectives

_SLO_KEYS = {"latency.p99.ms", "lag.ms", "window.blocks", "breach.blocks"}


def _slo_pass(app: SiddhiApp, sink: DiagnosticSink) -> None:
    """SA070-SA072: ``@app:slo`` hazards (core/ledger.py).  The runtime
    parses the annotation tolerantly — malformed values fall back to
    defaults with a log line — so these diagnostics are where the author
    learns a target was ignored."""
    slo = find_annotation(app.annotations, "app:slo")
    if slo is None:
        slo = find_annotation(app.annotations, "slo")
    if slo is None:
        return

    def num(key):
        raw = slo.get(key, None)
        if raw is None:
            return None, False
        try:
            return float(raw), False
        except (TypeError, ValueError):
            return None, True

    unknown = sorted(e.key for e in slo.elements
                     if e.key and e.key not in _SLO_KEYS)
    for k in unknown:
        sink.emit("SA071",
                  f"@app:slo option '{k}' is not read by the SLO engine "
                  f"(known options: latency.p99.ms, lag.ms, "
                  f"window.blocks, breach.blocks)")
    lat, bad_lat = num("latency.p99.ms")
    lag, bad_lag = num("lag.ms")
    wb, bad_wb = num("window.blocks")
    bb, bad_bb = num("breach.blocks")
    bad = bad_lat or bad_lag or bad_wb or bad_bb
    if not bad:
        bad = ((lat is not None and lat <= 0)
               or (lag is not None and lag <= 0)
               or (wb is not None and (wb <= 0 or wb != int(wb)))
               or (bb is not None and (bb <= 0 or bb != int(bb))))
    if bad:
        sink.emit("SA070",
                  "@app:slo options are invalid (latency.p99.ms / lag.ms "
                  "must be positive numbers, window.blocks / "
                  "breach.blocks positive integers); the runtime will "
                  "ignore the bad value and use the default")
    if lat is None and lag is None and not (bad_lat or bad_lag):
        sink.emit("SA072",
                  "@app:slo declares no latency.p99.ms and no lag.ms "
                  "target; the SLO engine has nothing to evaluate")


# ============================================================ aggregations

def _analyze_aggregations(table: SymbolTable, sink: DiagnosticSink) -> None:
    for aid, ad in table.app.aggregation_definitions.items():
        s = ad.basic_single_input_stream
        if s is None:
            continue
        scope = QueryScope(table, sink, aid)
        if not scope.bind_stream(s):
            continue
        checker = TypeChecker(scope, sink,
                              table.app.function_definitions, table.tables)
        for h in s.handlers:
            if isinstance(h, Filter):
                checker.check_condition(h.expr, "filter")
        sel = ad.selector
        if sel is not None and not sel.select_all:
            for oa in sel.attributes:
                checker.infer(oa.expr)
            for g in sel.group_by:
                scope.resolve(g)
        if ad.aggregate_attribute:
            scope.resolve(Variable(ad.aggregate_attribute))


# ================================================================ partition

def _analyze_partition(table: SymbolTable, part: Partition, pidx: int,
                       sink: DiagnosticSink, engine: str,
                       insert_targets: Set[str]) -> None:
    pname = f"partition_{pidx}"
    # partition keys resolve against their stream's own definition
    for pt in part.partition_types:
        d = table.source_definition(pt.stream_id)
        if d is None:
            sink.emit("SA001",
                      f"partition over unknown stream '{pt.stream_id}'",
                      pos=pos_of(pt) or pos_of(part), query=pname)
            continue
        table.mark_used(pt.stream_id)
        scope = QueryScope(table, sink, pname)
        scope.bind(pt.stream_id, pt.stream_id, d)
        checker = TypeChecker(scope, sink,
                              table.app.function_definitions, table.tables)
        if isinstance(pt, ValuePartitionType) and pt.expression is not None:
            checker.infer(pt.expression)
        elif isinstance(pt, RangePartitionType):
            for r in pt.ranges:
                checker.check_condition(r.condition, "range partition")
    table.inner.setdefault(id(part), {})
    for qi, q in enumerate(part.queries):
        qname = q.name or f"{pname}_query_{qi}"
        _analyze_query(table, q, qname, sink, engine, insert_targets,
                       partition=part)
        partition_pass(table, part, q, qname, sink)
        shard_pass(table, part, q, qname, sink)


# ==================================================================== query

def _analyze_query(table: SymbolTable, q: Query, qname: str,
                   sink: DiagnosticSink, engine: str,
                   insert_targets: Set[str],
                   partition: Optional[Partition]) -> None:
    scope = scope_for_input(table, q, sink, qname, partition)
    checker = TypeChecker(scope, sink, table.app.function_definitions,
                          table.tables)

    # ---- handler chains: filters, window params, stream-function args
    for s in _single_streams(q.input_stream):
        for h in s.handlers:
            if isinstance(h, Filter):
                checker.check_condition(h.expr, "filter")
            elif isinstance(h, WindowHandler):
                _check_window_params(h, qname, checker, sink)
            elif isinstance(h, StreamFunctionHandler):
                for p in h.params:
                    checker.infer(p)

    ins = q.input_stream
    if isinstance(ins, JoinInputStream) and ins.on is not None:
        checker.check_condition(ins.on, "join `on`")

    # ---- selector
    sel = q.selector
    out_attrs: Optional[List[Attribute]] = []
    if sel.select_all:
        if isinstance(ins, SingleInputStream):
            d = table.source_definition(ins.stream_id, partition,
                                        ins.is_inner)
            out_attrs = (list(d.attributes)
                         if d is not None and
                         ins.stream_id not in table.opaque else None)
            if d is not None:
                table.mark_whole(ins.stream_id)
        else:
            out_attrs = None        # join/pattern `select *`: opaque
            for s in _single_streams(ins):
                table.mark_whole(s.stream_id)
    else:
        for oa in sel.attributes:
            t = checker.infer(oa.expr)
            out_attrs.append(Attribute(oa.rename, t or AttrType.OBJECT))
    for g in sel.group_by:
        scope.resolve(g)
    if sel.having is not None:
        checker.check_condition(sel.having, "having")
    for ob in sel.order_by:
        scope.resolve(ob.variable)

    # ---- output action
    _analyze_output(table, q, qname, scope, checker, sink, out_attrs,
                    insert_targets, partition)

    # ---- state / perf passes
    state_pass(table, q, qname, sink)
    perf_pass(table, q, qname, sink, engine,
              in_partition=partition is not None)


def _check_window_params(h: WindowHandler, qname: str,
                         checker: TypeChecker, sink: DiagnosticSink) -> None:
    positions = _CONST_PARAM_POSITIONS.get(
        h.name.lower()) if not h.namespace else None
    for i, p in enumerate(h.params):
        if isinstance(p, (Constant, TimeConstant)):
            continue
        if positions is not None and i in positions:
            sink.emit(
                "SP003",
                f"#window.{h.name}(...) parameter {i + 1} must be a "
                f"constant — a data-dependent window shape cannot be "
                f"compiled",
                pos=pos_of(h), query=qname)
        else:
            checker.infer(p)


def _analyze_output(table: SymbolTable, q: Query, qname: str,
                    scope: QueryScope, checker: TypeChecker,
                    sink: DiagnosticSink,
                    out_attrs: Optional[List[Attribute]],
                    insert_targets: Set[str],
                    partition: Optional[Partition]) -> None:
    out = q.output_stream
    if out is None or isinstance(out, ReturnStream):
        return
    target = out.target_id

    if isinstance(out, (DeleteStream, UpdateStream, UpdateOrInsertStream)):
        td = table.tables.get(target) or table.windows.get(target)
        if td is None:
            sink.emit(
                "SA001",
                f"{type(out).__name__.replace('Stream', '').lower()} "
                f"targets unknown table/window '{target}'",
                pos=pos_of(out) or pos_of(q), query=qname)
            return
        table.mark_whole(target)
        insert_targets.add(target)
        # `on` / `set` clauses see both the event scope and the table
        scope.bind(target, target, td)
        if getattr(out, "on", None) is not None:
            checker.check_condition(out.on, "update/delete `on`")
        for sa in getattr(out, "set_assignments", []) or []:
            if sa.table_variable is not None:
                scope.resolve(sa.table_variable)
            if sa.value is not None:
                checker.infer(sa.value)
        return

    # insert into: table, named window, fault stream or (maybe inferred)
    # stream junction
    if out.is_fault:
        return
    if out.is_inner:
        if partition is not None:
            inner = table.inner.setdefault(id(partition), {})
            if out_attrs is None:
                # schema unknown (select * over a join/pattern): existence
                # is still known — register opaque so consumers resolve
                inner.setdefault(target, StreamDefinition(target))
                table.opaque.add(target)
            else:
                inner.setdefault(target,
                                 StreamDefinition(target, list(out_attrs)))
        return
    insert_targets.add(target)
    existing = (table.streams.get(target) or table.tables.get(target)
                or table.windows.get(target))
    if existing is not None:
        table.mark_whole(target)
        if out_attrs is not None and target not in table.opaque:
            _check_insert_schema(existing, out_attrs, out, qname, sink)
        return
    if target in table.aggregations:
        return
    # first writer defines the junction (runtime: junction_of create_with)
    if out_attrs is None:
        table.opaque.add(target)
        table.streams.setdefault(target, StreamDefinition(target))
    else:
        table.streams.setdefault(
            target, StreamDefinition(target, list(out_attrs)))


def _type_class(t: AttrType) -> str:
    if t in _NUMERIC:
        return "numeric"
    return t.value


def _check_insert_schema(d: AbstractDefinition, out_attrs: List[Attribute],
                         out, qname: str, sink: DiagnosticSink) -> None:
    if len(out_attrs) != len(d.attributes):
        sink.emit(
            "SA008",
            f"insert into '{d.id}': select produces {len(out_attrs)} "
            f"attribute(s) but '{d.id}' defines {len(d.attributes)}",
            pos=pos_of(out), query=qname)
        return
    for got, want in zip(out_attrs, d.attributes):
        if AttrType.OBJECT in (got.type, want.type):
            continue
        if _type_class(got.type) != _type_class(want.type):
            sink.emit(
                "SA008",
                f"insert into '{d.id}': attribute '{want.name}' expects "
                f"{want.type.value} but select provides "
                f"'{got.name}' of type {got.type.value}",
                pos=pos_of(out), query=qname)
            return
