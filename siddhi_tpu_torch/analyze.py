"""``python -m siddhi_tpu_torch.analyze`` — compile-time analysis CLI.

Usage:
    python -m siddhi_tpu_torch.analyze app.siddhi            # pretty output
    python -m siddhi_tpu_torch.analyze app.siddhi --json     # machine-readable
    python -m siddhi_tpu_torch.analyze app.siddhi --strict   # warnings = errors
    python -m siddhi_tpu_torch.analyze app.siddhi --plan     # plan-level verify
    python -m siddhi_tpu_torch.analyze - < app.siddhi        # read stdin
    python -m siddhi_tpu_torch.analyze --catalog             # list every code
    python -m siddhi_tpu_torch.analyze --catalog-md          # docs/analysis.md
                                                       # catalog section
    python -m siddhi_tpu_torch.analyze --engine              # engine
                                                       # self-analysis
                                                       # (CE/LW audit)
    python -m siddhi_tpu_torch.analyze app.siddhi --schema   # static persistent-
                                                       # state schema dump
    python -m siddhi_tpu_torch.analyze --schema              # declaration
                                                       # registry + SC002
                                                       # audit
    python -m siddhi_tpu_torch.analyze app.siddhi --numeric  # numeric-safety
                                                       # verifier (NS0xx
                                                       # value ranges)

Exit codes: 0 clean (infos allowed), 1 errors (or warnings under
--strict), 2 usage error.

The DEFAULT path imports no jax — this command runs fine on a machine
with no accelerator stack (tests/test_analysis.py asserts jax stays out
of sys.modules).  ``--plan`` is the explicit opt-in that builds the
runtime, extracts the Plan-IR, runs the automaton verifier + jaxpr
kernel sanitizer + static cost model (PV0xx/PC0xx codes), and therefore
lazily imports the jax-backed planner.
"""
from __future__ import annotations

import argparse
import json
import sys


def _print_catalog() -> None:
    from .analysis import CATALOG
    for code in sorted(CATALOG):
        e = CATALOG[code]
        print(f"{code}  {e.severity.value:<7}  {e.title}")
        print(f"       {e.meaning}")
        print(f"       fix: {e.fix}")


def _plan_result(text: str, engine, hbm_budget):
    """--plan: build the app (lazy jax import via the planner), attach
    the plan-level verification (with the jaxpr sanitizer on) and return
    the merged AnalysisResult."""
    from .analysis.plan_verify import attach_plan_analysis
    from .core.runtime import SiddhiManager
    m = SiddhiManager()
    rt = m.create_siddhi_app_runtime(text)
    try:
        attach_plan_analysis(rt, hbm_budget_mb=hbm_budget, jaxpr=True)
        return rt.analysis
    finally:
        rt.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m siddhi_tpu_torch.analyze",
        description="Static semantic analysis for SiddhiQL apps: type "
                    "checking, unbounded-state, retrace-hazard, "
                    "partition-safety and host-fallback diagnostics; "
                    "--plan adds compiled-plan verification (automaton "
                    "reachability, jaxpr sanitation, HBM/FLOP cost).")
    ap.add_argument("app", nargs="?",
                    help="path to a .siddhi app file, or '-' for stdin")
    ap.add_argument("--json", action="store_true",
                    help="emit diagnostics as a JSON array")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too")
    ap.add_argument("--engine", nargs="?", const="self",
                    choices=("auto", "device", "host", "self"),
                    help="with a value (auto/device/host): override the "
                         "engine mode assumed by the SP0xx performance "
                         "passes.  Bare --engine (no value): run the "
                         "engine self-analysis instead — the CE0xx "
                         "lock-order/blocking audit and CE1xx hot-path "
                         "lint over siddhi_tpu_torch's own source (no app "
                         "argument, no jax import).  Note: bare --engine "
                         "greedily consumes a following app path; use "
                         "--engine=auto etc. when combining with an app.")
    ap.add_argument("--plan", action="store_true",
                    help="build the runtime and run the plan-level "
                         "verifier + cost model (imports jax)")
    ap.add_argument("--hbm-budget", type=float, metavar="MB",
                    help="with --plan: emit PC002 when the predicted "
                         "persistent HBM footprint exceeds this budget")
    ap.add_argument("--schema", action="store_true",
                    help="with an app: dump its static persistent-state "
                         "schema (element ids, governing declarations, "
                         "engine routing, layout digests) — no jax "
                         "import.  Without an app: print every "
                         "@persistent_schema declaration in the engine "
                         "source and run the SC002 audit")
    ap.add_argument("--numeric", action="store_true",
                    help="run only the numeric-safety verifier: the "
                         "NS0xx value-range / precision pass seeded "
                         "from @attr:range and @app:rate declarations "
                         "— no jax import; exits 1 on warning-level "
                         "findings")
    ap.add_argument("--catalog", action="store_true",
                    help="print the diagnostic catalog and exit")
    ap.add_argument("--catalog-md", action="store_true",
                    help="print the generated docs/analysis.md catalog "
                         "section and exit")
    args = ap.parse_args(argv)

    if args.catalog:
        _print_catalog()
        return 0
    if args.catalog_md:
        from .analysis import catalog_markdown
        print(catalog_markdown())
        return 0
    if args.engine == "self":
        from .analysis.engine import analyze_engine
        report = analyze_engine()
        if args.json:
            print(json.dumps({"ok": report.ok,
                              "engine_audit": report.as_dicts()},
                             indent=1))
        else:
            print(report.render())
        if report.errors or report.stale_allowlist \
                or (args.strict and report.warnings):
            return 1
        return 0
    if args.schema and not args.app:
        # declaration registry + SC002 audit over the engine source —
        # static, jax-free, no app needed
        from .analysis.state_schema import (audit_declarations,
                                            static_declarations)
        decls = static_declarations()
        findings = audit_declarations()
        if args.json:
            print(json.dumps(
                {"ok": not findings,
                 "declarations": {k: d.as_dict()
                                  for k, d in sorted(decls.items())},
                 "findings": [{"code": c, "message": m}
                              for c, m in findings]}, indent=1))
        else:
            for k in sorted(decls):
                d = decls[k]
                print(f"{d.name:<22} v{d.version}  {d.digest()}  {k}")
            for c, m in findings:
                print(f"{c}: {m}")
            print(f"{len(decls)} declaration(s), "
                  f"{len(findings)} audit finding(s)")
        return 1 if findings else 0
    if not args.app:
        ap.print_usage(sys.stderr)
        return 2
    if args.app == "-":
        text = sys.stdin.read()
        name = "<stdin>"
    else:
        try:
            with open(args.app) as f:
                text = f.read()
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        name = args.app

    if args.numeric:
        from .analysis.ranges import analyze_numeric
        try:
            report = analyze_numeric(
                text, engine=None if args.engine in (None, "self")
                else args.engine)
        except Exception as e:  # noqa: BLE001 — CLI boundary
            print(f"error: {e}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(report.as_dict(), indent=1))
        else:
            print(report.dump(), end="")
        bad = [d for d in report.findings
               if d.severity.value != "info" or args.strict]
        return 1 if bad else 0

    if args.schema:
        from .analysis.state_schema import extract_app_schema
        try:
            schema = extract_app_schema(
                text, engine=None if args.engine in (None, "self")
                else args.engine)
        except Exception as e:  # noqa: BLE001 — CLI boundary
            print(f"error: {e}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(schema.as_dict(), indent=1))
        else:
            print(schema.dump(), end="")
        return 1 if schema.findings else 0

    if args.plan:
        try:
            result = _plan_result(text, args.engine, args.hbm_budget)
        except Exception as e:  # noqa: BLE001 — CLI boundary
            print(f"error: plan build failed: {e}", file=sys.stderr)
            return 1
    else:
        from .analysis import analyze
        result = analyze(text, engine=args.engine)

    if args.json:
        doc = {"app": result.app_name,
               "ok": result.ok,
               "diagnostics": result.as_dicts()}
        plan = getattr(result, "plan", None)
        if plan is not None:
            doc["plan"] = plan.as_dict()
        print(json.dumps(doc, indent=1))
    else:
        print(result.render(name))
        plan = getattr(result, "plan", None)
        if plan is not None:
            c = plan.cost
            print(f"plan: {len(plan.plan.automata)} automaton/automata, "
                  f"{len(plan.plan.programs)} program(s), "
                  f"{plan.pruned_states} state(s) pruned, "
                  f"predicted HBM {c.total_hbm_bytes} B, "
                  f"~{c.total_flops_per_event} FLOPs/event")

    if result.errors or (args.strict and result.warnings):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
