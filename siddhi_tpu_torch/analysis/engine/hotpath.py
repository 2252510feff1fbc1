"""Hot-path lint: CE1xx checks over ``@hot_path``-decorated functions.

Functions the engine marks with ``core.hotpath.hot_path(...)`` run per
ingest block or per event; this pass re-discovers them purely from the
AST (no engine import — the no-jax guarantee) and checks each body for
the slow idioms the repo has already paid to remove:

  * CE101 — ``os.environ`` reads.  Resolved transitively (depth-limited,
    across engine modules through their import maps) so a hot function
    that reads env through a helper or property is still caught; helpers
    that use the verified fast idiom — reading a module global assigned
    from ``getattr(os.environ, "_data", ...)``, like core/ledger.py's
    ``ledger_enabled`` — pass.  The verification is structural, so the
    "fast helper" set cannot rot: a helper that loses the idiom goes
    back to being a finding.
  * CE102 — eager ``.to_events()`` in the hot body (per-event object
    materialization from a columnar chunk; the GC find).
  * CE103 — dict-per-event construction: a dict literal/`dict()` call
    built inside a loop or comprehension over rows.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .lockgraph import EngineFinding, _dotted, _iter_engine_modules

_NONE, _FAST, _SLOW = 0, 1, 2
_MAX_DEPTH = 4


@dataclass
class _Func:
    node: ast.AST
    modrel: str
    relpath: str
    qualname: str
    cls: Optional[str]
    is_property: bool = False
    hot_reason: Optional[str] = None


@dataclass
class _Module:
    modrel: str
    relpath: str
    funcs: Dict[str, _Func] = field(default_factory=dict)   # qual -> func
    properties: Dict[Tuple[str, str], str] = field(default_factory=dict)
    imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    fast_globals: Set[str] = field(default_factory=set)


def _resolve_relative(modrel: str, level: int, module: Optional[str]) -> str:
    """'from .ledger import x' inside core.stream -> 'core.ledger'."""
    parts = modrel.split(".")
    base = parts[:len(parts) - level] if level <= len(parts) else []
    if module:
        base = base + module.split(".")
    return ".".join(base)


class HotPathAuditor:
    def __init__(self):
        self.modules: Dict[str, _Module] = {}
        self.findings: List[EngineFinding] = []
        self.hot_functions: Dict[str, str] = {}   # dotted name -> reason
        self._verdict_memo: Dict[Tuple[str, str], Tuple[int, str]] = {}

    # ------------------------------------------------------------ intake

    def add_module(self, text: str, modrel: str, relpath: str):
        tree = ast.parse(text)
        mod = _Module(modrel=modrel, relpath=relpath)
        self.modules[modrel] = mod

        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.level >= 0:
                target = _resolve_relative(modrel, node.level, node.module) \
                    if node.level else (node.module or "")
                for alias in node.names:
                    mod.imports[alias.asname or alias.name] = (
                        target, alias.name)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                if self._is_env_data_getattr(node.value):
                    mod.fast_globals.add(node.targets[0].id)

        def add_func(fn, cls):
            qual = f"{cls}.{fn.name}" if cls else fn.name
            reason = self._hot_reason(fn)
            is_prop = any(isinstance(d, ast.Name) and d.id == "property"
                          for d in fn.decorator_list)
            mod.funcs[qual] = _Func(node=fn, modrel=modrel, relpath=relpath,
                                    qualname=qual, cls=cls,
                                    is_property=is_prop, hot_reason=reason)
            if is_prop and cls:
                mod.properties[(cls, fn.name)] = qual
            if reason is not None:
                self.hot_functions[f"{modrel}.{qual}"] = reason

        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add_func(node, None)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        add_func(sub, node.name)

    @staticmethod
    def _hot_reason(fn) -> Optional[str]:
        for d in fn.decorator_list:
            if isinstance(d, ast.Call):
                callee = _dotted(d.func) or ""
                if callee.rsplit(".", 1)[-1] == "hot_path":
                    if d.args and isinstance(d.args[0], ast.Constant):
                        return str(d.args[0].value)
                    return ""
        return None

    @staticmethod
    def _is_env_data_getattr(value: ast.AST) -> bool:
        return (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "getattr"
                and len(value.args) >= 2
                and _dotted(value.args[0]) == "os.environ"
                and isinstance(value.args[1], ast.Constant)
                and value.args[1].value == "_data")

    # ----------------------------------------------------------- verdicts

    def _env_verdict(self, modrel: str, qual: str,
                     depth: int = 0,
                     visiting: Optional[Set[Tuple[str, str]]] = None
                     ) -> Tuple[int, str]:
        """(verdict, chain) for a function: does it reach os.environ,
        and through the fast idiom or the slow public API?"""
        key = (modrel, qual)
        if key in self._verdict_memo:
            return self._verdict_memo[key]
        mod = self.modules.get(modrel)
        fn = mod.funcs.get(qual) if mod else None
        if fn is None:
            return (_NONE, "")
        visiting = visiting or set()
        if key in visiting or depth > _MAX_DEPTH:
            return (_NONE, "")
        visiting.add(key)

        direct_env = False
        reads_fast = False
        for node in ast.walk(fn.node):
            d = _dotted(node) if isinstance(node, ast.Attribute) else None
            if d and (d == "os.environ" or d.startswith("os.environ.")
                      or d == "os.getenv"):
                direct_env = True
            if isinstance(node, ast.Name) and node.id in mod.fast_globals:
                reads_fast = True

        if direct_env:
            v = (_FAST if reads_fast else _SLOW,
                 f"{modrel}.{qual}")
            self._verdict_memo[key] = v
            return v

        best = (_NONE, "")
        for tmod, tqual in self._callees(fn, mod):
            sub, chain = self._env_verdict(tmod, tqual, depth + 1, visiting)
            if sub > best[0]:
                best = (sub, f"{modrel}.{qual} -> {chain}")
                if sub == _SLOW:
                    break
        self._verdict_memo[key] = best
        return best

    def _callees(self, fn: _Func, mod: _Module):
        """Resolvable callees/property-reads of a function body."""
        out: List[Tuple[str, str]] = []
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                callee = _dotted(node.func)
                if not callee:
                    continue
                if callee.startswith("self.") and "." not in callee[5:] \
                        and fn.cls:
                    out.append((fn.modrel, f"{fn.cls}.{callee[5:]}"))
                elif "." not in callee:
                    if callee in mod.funcs:
                        out.append((fn.modrel, callee))
                    elif callee in mod.imports:
                        tmod, orig = mod.imports[callee]
                        out.append((tmod, orig))
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" and fn.cls:
                prop = mod.properties.get((fn.cls, node.attr))
                if prop:
                    out.append((fn.modrel, prop))
        return out

    # ------------------------------------------------------------ checks

    def finish(self) -> List[EngineFinding]:
        for mod in self.modules.values():
            for fn in mod.funcs.values():
                if fn.hot_reason is None:
                    continue
                self._check_env(fn, mod)
                self._check_to_events(fn)
                self._check_dict_per_row(fn)
        return self.findings

    def _check_env(self, fn: _Func, mod: _Module):
        verdict, chain = self._env_verdict(fn.modrel, fn.qualname)
        if verdict == _SLOW:
            self.findings.append(EngineFinding(
                code="CE101",
                message=f"os.environ read on hot path via {chain} "
                        f"(hot: {fn.hot_reason})",
                relpath=fn.relpath, qualname=fn.qualname,
                line=fn.node.lineno, col=fn.node.col_offset))

    def _check_to_events(self, fn: _Func):
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "to_events":
                self.findings.append(EngineFinding(
                    code="CE102",
                    message=f"eager .to_events() in hot function "
                            f"(hot: {fn.hot_reason})",
                    relpath=fn.relpath, qualname=fn.qualname,
                    line=node.lineno, col=node.col_offset))

    def _check_dict_per_row(self, fn: _Func):
        def has_dict_build(n: ast.AST) -> Optional[ast.AST]:
            for sub in ast.walk(n):
                if isinstance(sub, ast.Dict):
                    return sub
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Name) \
                        and sub.func.id == "dict":
                    return sub
            return None

        for node in ast.walk(fn.node):
            hit = None
            if isinstance(node, ast.For):
                for stmt in node.body:
                    hit = has_dict_build(stmt)
                    if hit:
                        break
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp)):
                hit = has_dict_build(node.elt)
            if hit is not None:
                self.findings.append(EngineFinding(
                    code="CE103",
                    message=f"dict built per loop iteration in hot "
                            f"function (hot: {fn.hot_reason})",
                    relpath=fn.relpath, qualname=fn.qualname,
                    line=hit.lineno, col=hit.col_offset))


# ------------------------------------------------------------------ API


def audit_hot_paths(root: Optional[str] = None) -> HotPathAuditor:
    auditor = HotPathAuditor()
    for text, modrel, relpath in _iter_engine_modules(root):
        auditor.add_module(text, modrel, relpath)
    auditor.finish()
    return auditor


def analyze_module_source(text: str, modrel: str = "mod",
                          relpath: str = "mod.py") -> HotPathAuditor:
    """Single-module entry point for unit tests."""
    auditor = HotPathAuditor()
    auditor.add_module(text, modrel, relpath)
    auditor.finish()
    return auditor
