"""siddhi_tpu_torch.analysis — compile-time semantic analysis for SiddhiQL apps.

Public surface:

    from siddhi_tpu_torch.analysis import analyze, AnalysisResult, Diagnostic

    result = analyze(app_text)          # or a query_api SiddhiApp
    for d in result.diagnostics:
        print(d.render("app.siddhi"))
    result.raise_if(strict=True)        # warnings promote to errors

Plan-level surface — a verifier over the *compiled* plan:

    from siddhi_tpu_torch.analysis import extract_plan, verify_plan

    rt = manager.create_siddhi_app_runtime(app)   # plan report attaches
    rt.analysis.plan                              # PlanReport (PV/PC codes,
                                                  # pruned-state counts, cost)

Engine self-analysis — the CE/LW concurrency + hot-path audit
over siddhi_tpu_torch's own source:

    from siddhi_tpu_torch.analysis import analyze_engine

    report = analyze_engine()           # CE0xx/CE1xx, allowlist-aware
    report.raise_if(strict=True)        # the tests/test_engine_lint gate

Persistent-state schema surface — the static checkpoint-
compatibility layer (SC0xx):

    from siddhi_tpu_torch.analysis import extract_app_schema, audit_declarations

    schema = extract_app_schema(app_text)   # element ids, declarations,
    schema.dump(); schema.digest()          # routing, layout digests —
                                            # derived without jax
    rt.analysis.schema                      # StateSchemaReport on the
                                            # live runtime (also /stats)

Numeric-safety surface — the static value-range & precision
verifier (NS0xx) with SIDDHI_TPU_NUMGUARD runtime sentinels (NS101):

    from siddhi_tpu_torch.analysis import analyze_numeric

    report = analyze_numeric(app_text)      # interval lattice seeded
    report.counts(); report.dump()          # from @attr:range/@app:rate
    rt.analysis.numeric                     # plan-grounded refinement
                                            # (also GET /stats)

CLI: ``python -m siddhi_tpu_torch.analyze app.siddhi [--json] [--strict]
[--plan] [--schema] [--numeric]``; ``python -m siddhi_tpu_torch.analyze
--engine`` for the audit; bare ``--schema`` for the declaration
registry + SC002 audit.
Everything importable here stays jax-free; only the jaxpr
sanitizer (plan_verify.sanitize_runtime) imports jax, lazily.
Diagnostic catalog: docs/analysis.md (generated from
diagnostics.catalog_markdown()).
"""
from .analyzer import AnalysisResult, analyze
from .cost_model import CostReport, plan_cost
from .diagnostics import (CATALOG, CatalogEntry, Diagnostic, Severity,
                          catalog_markdown)
from .engine import EngineReport, analyze_engine, static_lock_edges
from .plan_ir import AutomatonIR, PlanIR, ProgramIR, extract_plan
from .ranges import (Interval, NumericReport, analyze_numeric,
                     attach_numeric_analysis, collect_attr_ranges,
                     numeric_pass, sample_numeric_counts, ts32_safe_max)
from .plan_verify import (PlanReport, attach_plan_analysis,
                          verify_automaton, verify_plan)
from .state_schema import (AppStateSchema, StateSchemaReport,
                           attach_schema_analysis, audit_declarations,
                           extract_app_schema, extract_runtime_schema,
                           sample_schema_digests, static_declarations)

__all__ = ["analyze", "AnalysisResult", "Diagnostic", "Severity",
           "CATALOG", "CatalogEntry", "catalog_markdown",
           "PlanIR", "AutomatonIR", "ProgramIR", "extract_plan",
           "CostReport", "plan_cost",
           "PlanReport", "verify_plan", "verify_automaton",
           "attach_plan_analysis",
           "EngineReport", "analyze_engine", "static_lock_edges",
           "Interval", "NumericReport", "analyze_numeric",
           "attach_numeric_analysis", "collect_attr_ranges",
           "numeric_pass", "sample_numeric_counts", "ts32_safe_max",
           "AppStateSchema", "StateSchemaReport",
           "attach_schema_analysis", "audit_declarations",
           "extract_app_schema", "extract_runtime_schema",
           "sample_schema_digests", "static_declarations"]
