"""Engine self-analysis: the CE/LW concurrency + hot-path audit.

``analyze_engine()`` runs the static lock-graph pass (lockgraph.py,
CE0xx) and the hot-path lint (hotpath.py, CE1xx) over the installed
``siddhi_tpu_torch`` source tree and returns an :class:`EngineReport`.
Findings whose ``(code, "relpath::qualname")`` key appears in
:data:`ALLOWLIST` are carried as *allowlisted* (visible in JSON, not
fatal); everything else fails ``--strict`` and the
tests/test_engine_lint.py gate.  The allowlist is deliberately small
and every entry must say *why* the pattern is safe — an entry without a
justification, or one that no longer matches a finding, fails the gate
too, so the list cannot rot into a mute button.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ...query_api.position import SourcePos
from ..diagnostics import CATALOG, Diagnostic, Severity
from .hotpath import HotPathAuditor, audit_hot_paths
from .lockgraph import (EngineFinding, LockGraphAuditor, audit_lock_graph,
                        static_lock_edges)

#: (code, "relpath::qualname") -> why this specific site is safe.
ALLOWLIST: Dict[Tuple[str, str], str] = {
    ("CE005", "siddhi_tpu_torch/core/stream.py::StreamJunction.flush"):
        "flush() hands one sentinel barrier per worker queue while "
        "holding _flush_lock; the queues are the workers' own and the "
        "put is bounded by the worker-liveness wait loop directly "
        "below (b.done.wait(timeout=1.0) re-checks thread health), so "
        "a dead worker cannot park flush forever.",
}


@dataclass
class EngineReport:
    """Result surface for `analyze --engine`, shaped like
    analyzer.AnalysisResult so the CLI/JSON handling is uniform."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    allowlisted: List[Diagnostic] = field(default_factory=list)
    lock_ids: List[str] = field(default_factory=list)
    lock_edges: List[Tuple[str, str]] = field(default_factory=list)
    hot_functions: Dict[str, str] = field(default_factory=dict)
    stale_allowlist: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.diagnostics and not self.stale_allowlist

    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    def as_dicts(self) -> Dict[str, Any]:
        return {
            "diagnostics": [d.as_dict() for d in self.diagnostics],
            "allowlisted": [d.as_dict() for d in self.allowlisted],
            "locks": self.lock_ids,
            "edges": [list(e) for e in self.lock_edges],
            "hot_functions": self.hot_functions,
            "stale_allowlist": [list(k) for k in self.stale_allowlist],
        }

    def render(self) -> str:
        lines = []
        for d in self.diagnostics:
            lines.append(d.render(d.extra.get("file", "<engine>")))
        for d in self.allowlisted:
            lines.append(d.render(d.extra.get("file", "<engine>"))
                         + "  [allowlisted]")
        for key in self.stale_allowlist:
            lines.append(f"<allowlist>: error STALE {key}: entry matches "
                         f"no finding — remove it")
        lines.append(
            f"engine audit: {len(self.lock_ids)} locks, "
            f"{len(self.lock_edges)} order edges, "
            f"{len(self.hot_functions)} hot functions; "
            f"{len(self.diagnostics)} findings "
            f"({len(self.allowlisted)} allowlisted)")
        return "\n".join(lines)

    def raise_if(self, strict: bool = False):
        bad = self.errors + (self.warnings if strict else [])
        if bad or self.stale_allowlist:
            raise EngineAuditError(self)


class EngineAuditError(Exception):
    def __init__(self, report: EngineReport):
        self.report = report
        super().__init__(report.render())


def _to_diagnostic(f: EngineFinding) -> Diagnostic:
    return Diagnostic(
        code=f.code, message=f.message,
        pos=SourcePos(f.line, f.col),
        extra={"file": f.relpath, "qualname": f.qualname})


def analyze_engine(root: Optional[str] = None,
                   allowlist: Optional[Dict[Tuple[str, str], str]] = None
                   ) -> EngineReport:
    """Run the full CE0xx + CE1xx audit over the engine source."""
    if allowlist is None:
        allowlist = ALLOWLIST
    lock_audit = audit_lock_graph(root)
    hot_audit = audit_hot_paths(root)

    report = EngineReport(
        lock_ids=sorted(lock_audit.locks),
        lock_edges=sorted(lock_audit.edges),
        hot_functions=dict(sorted(hot_audit.hot_functions.items())))

    matched: set = set()
    for f in lock_audit.findings + hot_audit.findings:
        d = _to_diagnostic(f)
        if f.key in allowlist:
            matched.add(f.key)
            d.extra["allowlisted"] = allowlist[f.key]
            report.allowlisted.append(d)
        else:
            report.diagnostics.append(d)
    report.stale_allowlist = sorted(k for k in allowlist if k not in matched)
    return report


__all__ = ["ALLOWLIST", "EngineAuditError", "EngineReport",
           "HotPathAuditor", "LockGraphAuditor", "analyze_engine",
           "audit_hot_paths", "audit_lock_graph", "static_lock_edges"]
