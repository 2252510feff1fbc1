"""Plan-level static verifier: runs after plan, before (or without) jit.

Three analysis families over the Plan-IR (analysis/plan_ir.py), each
with stable codes in diagnostics.CATALOG:

  1. **Automaton verification** (PV001-PV005) — transition-table
     well-formedness (no dangling state ids), start-reachability,
     accept-liveness (a plan whose accept state is unreachable can
     never match — Hyperscan-style compile-time graph analysis),
     `within`-bound propagation against summed absent waits, and the
     liveness-pruning report (states deleted with match output proven
     unchanged).
  2. **Jaxpr kernel sanitizer** (PV010-PV013) — JAX-only: the torch
     port has no jaxpr to scan, so a request for it is recorded in
     ``PlanReport.skipped`` instead of running.
  3. **Static cost model** (PC001-PC003, analysis/cost_model.py) —
     HBM footprint and FLOP-per-event estimates with a budget gate.

Entry points:
  * :func:`verify_automaton` — unit-testable piece;
  * :func:`verify_plan` — PlanIR (+ optional runtime) -> :class:`PlanReport`;
  * :func:`attach_plan_analysis` — wires the report and its
    diagnostics into ``rt.analysis`` (create_siddhi_app_runtime calls
    this after the plan is built).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .cost_model import CostReport, cost_diagnostics, plan_cost
from .diagnostics import Diagnostic, Severity
from .plan_ir import AutomatonIR, PlanIR, extract_plan

# =================================================== automaton verification

def verify_automaton(a: AutomatonIR) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    S = len(a.states)
    accept = a.accept

    # PV001 — dangling state ids in the transition table
    for (src, label, dst) in a.transitions:
        if not (0 <= src < S) or not (0 <= dst <= accept):
            diags.append(Diagnostic(
                "PV001",
                f"transition ({src} --{label}--> {dst}) references a "
                f"state outside [0, {accept}]", query=a.query))
    if any(d.code == "PV001" for d in diags):
        return diags        # graph algorithms below assume a sane table

    # forward reachability from the start states
    fwd: Dict[int, set] = {}
    for (src, _label, dst) in a.transitions:
        fwd.setdefault(src, set()).add(dst)
    seen = set()
    stack = [s for s in a.start_states if 0 <= s <= accept]
    while stack:
        n = stack.pop()
        if n in seen or n == accept:
            if n == accept:
                seen.add(n)
            continue
        seen.add(n)
        stack.extend(fwd.get(n, ()))
    for s in a.states:
        if s.idx not in seen:
            diags.append(Diagnostic(
                "PV003",
                f"state s{s.idx} ({s.kind} on "
                f"{','.join(s.streams)}) is unreachable from the start "
                f"state", query=a.query))

    # accept liveness: PV002 when no start can reach accept — either
    # structurally, or because pruning proved a condition statically
    # false / a dead-start shape (the kernel suppresses arming there)
    if a.statically_dead or accept not in seen:
        why = "a condition folds to constant false" \
            if a.statically_dead and not a.dead_start else \
            "the SEQUENCE leading kleene min>=2 barrier kills every " \
            "sub-min accumulator" if a.dead_start else \
            "no transition path reaches accept"
        diags.append(Diagnostic(
            "PV002",
            f"accept state is unreachable — the pattern can never "
            f"match ({why}); the device step is skipped for this plan",
            query=a.query))

    # PV004 — liveness pruning report
    if a.pruned_states or a.simplified_conditions:
        diags.append(Diagnostic(
            "PV004",
            f"liveness pruning removed {a.pruned_states} state(s) and "
            f"simplified {a.simplified_conditions} condition(s); match "
            f"output is unchanged",
            query=a.query,
            extra={"pruned_states": a.pruned_states,
                   "simplified_conditions": a.simplified_conditions,
                   "notes": list(a.prune_notes)}))

    # PV005 — `within` bound vs summed absent waits on the match path
    if a.within_ms is not None:
        absent_wait = sum(s.waiting_ms for s in a.states
                          if s.kind == "absent")
        if absent_wait and absent_wait >= a.within_ms:
            diags.append(Diagnostic(
                "PV005",
                f"summed `not ... for t` waits ({absent_wait} ms) reach "
                f"the `within` bound ({a.within_ms} ms): partials expire "
                f"before the absence chain can confirm", query=a.query))
    return diags


# ====================================================== jaxpr sanitation

#: The jaxpr kernel sanitizer (PV010-PV013) reads JAX's traced program;
#: torch steps have no jaxpr, so the pass is reported as skipped.
SANITIZER_SKIPPED = ("PV010-PV013: jaxpr sanitizer not run under torch "
                     "(steps are eager PyTorch and hand-written kernels)")


# ============================================================= the report

@dataclass
class PlanReport:
    """Everything the plan verifier learned about a built runtime."""
    plan: PlanIR
    cost: CostReport
    diagnostics: List[Diagnostic] = field(default_factory=list)
    #: passes that did not run, each with its reason
    skipped: List[str] = field(default_factory=list)

    @property
    def pruned_states(self) -> int:
        return sum(a.pruned_states for a in self.plan.automata)

    @property
    def ok(self) -> bool:
        return not any(d.severity == Severity.ERROR
                       for d in self.diagnostics)

    def as_dict(self) -> Dict[str, Any]:
        return {"plan": self.plan.as_dict(),
                "cost": self.cost.as_dict(),
                "pruned_states": self.pruned_states,
                "diagnostics": [d.as_dict() for d in self.diagnostics],
                "skipped": list(self.skipped)}


def verify_plan(plan: PlanIR, rt=None,
                hbm_budget_mb: Optional[float] = None,
                jaxpr: bool = False) -> PlanReport:
    """Run the automaton + cost passes over a Plan-IR; with ``rt`` and
    ``jaxpr=True`` record the jaxpr pass as skipped (see above)."""
    diags: List[Diagnostic] = []
    for a in plan.automata:
        diags += verify_automaton(a)
    cost = plan_cost(plan)
    diags += cost_diagnostics(cost, hbm_budget_mb=hbm_budget_mb,
                              query=plan.app_name)
    skipped = [SANITIZER_SKIPPED] if jaxpr and rt is not None else []
    return PlanReport(plan=plan, cost=cost, diagnostics=diags,
                      skipped=skipped)


def attach_plan_analysis(rt, hbm_budget_mb: Optional[float] = None,
                         jaxpr: bool = False) -> PlanReport:
    """Extract + verify a built runtime's plan and merge the findings
    into ``rt.analysis`` (created if the runtime has none): plan
    diagnostics ride the same list as the source-level ones, sorted by
    the same (severity, line, code) key, and the full report is
    available as ``rt.analysis.plan`` (and via GET /stats)."""
    from .analyzer import AnalysisResult
    report = verify_plan(extract_plan(rt), rt=rt,
                         hbm_budget_mb=hbm_budget_mb, jaxpr=jaxpr)
    analysis = getattr(rt, "analysis", None)
    if analysis is None:
        analysis = AnalysisResult(app_name=getattr(rt, "name", None))
        rt.analysis = analysis
    prev = getattr(analysis, "plan", None)
    if prev is not None:     # idempotent re-attach (e.g. CLI --plan with
        #                      jaxpr on after the manager's default pass)
        stale = set(map(id, prev.diagnostics))
        analysis.diagnostics = [d for d in analysis.diagnostics
                                if id(d) not in stale]
    order = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}
    analysis.diagnostics = sorted(
        analysis.diagnostics + report.diagnostics,
        key=lambda d: (order[d.severity],
                       d.line if d.line >= 0 else 1 << 30, d.code))
    analysis.plan = report
    return report
