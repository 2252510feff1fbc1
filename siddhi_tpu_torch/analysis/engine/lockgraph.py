"""Static lock-order + blocking-primitive audit over the engine source.

This is self-analysis: the same AST discipline the SA/SP catalogs apply
to user queries, pointed at ``siddhi_tpu_torch/`` itself.  The auditor

  1. discovers engine locks — ``self.X = threading.Lock()/RLock()/
     Condition()`` (bare or wrapped in ``maybe_wrap``) — and names them
     ``<module>.<Class>.<attr>`` (the exact ids core/lockwitness.py
     wraps with, so the static graph and the runtime witness speak the
     same vocabulary);
  2. walks every function with a held-lock stack over ``with self.X:``
     regions, resolving one level of same-class calls, and builds the
     directed acquisition graph (edges also feed the runtime witness via
     :func:`static_lock_edges`);
  3. reports the CE0xx family: cycles in the graph (CE001), callbacks
     invoked under a lock (CE002 — the circuit-breaker class),
     ``time.sleep`` anywhere in engine code (CE003), timeout-less
     ``join``/queue ops/``wait`` in locked regions or worker bodies
     (CE004/CE005/CE007 — the blocking-put class), I/O under a lock (CE006),
     and unnamed engine threads (CE008).

Pure stdlib ``ast`` — importing this module (and running the audit)
never imports the engine, so ``analyze --engine`` keeps the no-jax
guarantee.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
#: attribute-name fragments that mark a collection of user callbacks
CALLBACK_HINTS = ("listener", "callback", "subscriber", "hook")
#: receiver-name shapes that mark a queue.Queue-ish object
_QUEUEISH_EXACT = {"q", "dlq"}
#: call targets that are file/socket I/O when made under a lock
IO_CALLS = {"open", "json.dump", "pickle.dump", "urlopen",
            "os.remove", "os.rename", "os.replace", "os.makedirs",
            "shutil.rmtree", "shutil.move"}


@dataclass
class EngineFinding:
    """One auditor hit, file-anchored (converted to a catalog
    Diagnostic by analysis.engine.analyze_engine)."""
    code: str
    message: str
    relpath: str
    qualname: str
    line: int
    col: int

    @property
    def key(self) -> Tuple[str, str]:
        """Allowlist key: (code, "relpath::qualname")."""
        return (self.code, f"{self.relpath}::{self.qualname}")


def _dotted(node: ast.AST) -> Optional[str]:
    """Dotted name of an expression ('time.sleep', 'self._deliver'),
    or None when it isn't a plain name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _queueish(recv: Optional[str]) -> bool:
    if not recv:
        return False
    last = recv.rsplit(".", 1)[-1].lower()
    return (last in _QUEUEISH_EXACT or "queue" in last
            or last.endswith("_q") or last.startswith("q_"))


def _has_any_arg(call: ast.Call) -> bool:
    return bool(call.args) or bool(call.keywords)


def _has_timeout_kw(call: ast.Call, positional_from: int) -> bool:
    """True when the call carries a timeout: a `timeout=`/`block=` kwarg
    or a positional arg at/after index `positional_from`."""
    if len(call.args) > positional_from:
        return True
    return any(k.arg in ("timeout", "block") for k in call.keywords)


@dataclass
class _FuncInfo:
    node: ast.AST                       # FunctionDef / AsyncFunctionDef
    qualname: str                       # Class.method / func / Class.m.inner
    cls: Optional[str]
    is_property: bool = False
    acquires: List[Tuple[str, ast.AST]] = field(default_factory=list)
    callback_calls: List[ast.AST] = field(default_factory=list)
    is_worker: bool = False


class LockGraphAuditor:
    """Multi-module auditor: feed modules with :meth:`add_module`, then
    :meth:`finish` for the cross-module cycle pass."""

    def __init__(self):
        self.locks: Set[str] = set()                    # lock ids
        self.lock_attrs: Dict[Tuple[str, str], str] = {}  # (cls, attr)->id
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}  # ->(file, line)
        self.findings: List[EngineFinding] = []
        self._funcs: Dict[str, _FuncInfo] = {}          # "modrel:qual"->info
        self._reported: Set[Tuple[str, str, int]] = set()

    # ------------------------------------------------------------ intake

    def add_module(self, text: str, modrel: str, relpath: str):
        tree = ast.parse(text)
        funcs = self._index(tree, modrel, relpath)
        self._mark_workers(funcs, modrel)
        for info in funcs.values():
            self._scan_function(info, modrel, relpath, funcs)

    # ------------------------------------------------------------ pass 1

    def _index(self, tree: ast.Module, modrel: str,
               relpath: str) -> Dict[str, _FuncInfo]:
        funcs: Dict[str, _FuncInfo] = {}

        def add_func(node, qual, cls):
            deco_props = any(
                (isinstance(d, ast.Name) and d.id == "property")
                for d in node.decorator_list)
            info = _FuncInfo(node=node, qualname=qual, cls=cls,
                             is_property=deco_props)
            funcs[qual] = info
            self._funcs[f"{modrel}:{qual}"] = info
            # nested defs (worker closures like statistics' `loop`)
            for inner in ast.iter_child_nodes(node):
                self._walk_nested(inner, qual, cls, funcs, modrel)

        def walk_body(body, cls):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{cls}.{node.name}" if cls else node.name
                    add_func(node, qual, cls)
                elif isinstance(node, ast.ClassDef):
                    walk_body(node.body, node.name)

        walk_body(tree.body, None)

        # lock discovery: self.X = Lock()/maybe_wrap(Lock(), "...")
        for info in list(funcs.values()):
            if info.cls is None:
                continue
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                    continue
                tgt = node.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                lock_id = self._lock_value_id(node.value, modrel,
                                              info.cls, tgt.attr)
                if lock_id:
                    self.locks.add(lock_id)
                    self.lock_attrs[(info.cls, tgt.attr)] = lock_id
        return funcs

    def _walk_nested(self, node, outer_qual, cls, funcs, modrel):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{outer_qual}.{node.name}"
            info = _FuncInfo(node=node, qualname=qual, cls=cls)
            funcs[qual] = info
            self._funcs[f"{modrel}:{qual}"] = info
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, ast.ClassDef):
                self._walk_nested(child, outer_qual, cls, funcs, modrel)

    def _lock_value_id(self, value: ast.AST, modrel: str, cls: str,
                       attr: str) -> Optional[str]:
        call = value
        if isinstance(call, ast.Call):
            callee = _dotted(call.func)
            if callee and callee.rsplit(".", 1)[-1] == "maybe_wrap":
                # use the declared witness name when it is a literal
                if len(call.args) >= 2 and isinstance(call.args[1],
                                                      ast.Constant) \
                        and isinstance(call.args[1].value, str):
                    inner = call.args[0]
                    if self._is_lock_factory(inner):
                        return call.args[1].value
                if call.args and self._is_lock_factory(call.args[0]):
                    return f"{modrel}.{cls}.{attr}"
            if self._is_lock_factory(call):
                return f"{modrel}.{cls}.{attr}"
        return None

    @staticmethod
    def _is_lock_factory(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        callee = _dotted(node.func)
        return bool(callee) and callee.rsplit(".", 1)[-1] in LOCK_FACTORIES

    # ------------------------------------------------------------ workers

    def _mark_workers(self, funcs: Dict[str, _FuncInfo], modrel: str):
        """Resolve Thread(target=...) / Timer(delay, fn) to functions in
        this module and mark them as worker bodies (their blocking ops
        wedge a thread nobody can join)."""
        for info in list(funcs.values()):
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = _dotted(node.func) or ""
                base = callee.rsplit(".", 1)[-1]
                if base not in ("Thread", "Timer"):
                    continue
                target = None
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
                if base == "Timer" and target is None and len(node.args) >= 2:
                    target = node.args[1]
                if target is None:
                    continue
                tgt_name = _dotted(target)
                if not tgt_name:
                    continue
                cand = None
                if tgt_name.startswith("self.") and info.cls:
                    cand = funcs.get(f"{info.cls}.{tgt_name[5:]}")
                elif "." not in tgt_name:
                    cand = (funcs.get(f"{info.qualname}.{tgt_name}")
                            or funcs.get(tgt_name)
                            or (funcs.get(f"{info.cls}.{tgt_name}")
                                if info.cls else None))
                if cand is not None:
                    cand.is_worker = True

    # ------------------------------------------------------------ pass 2

    def _scan_function(self, info: _FuncInfo, modrel: str, relpath: str,
                       funcs: Dict[str, _FuncInfo]):
        cb_vars: Set[str] = set()
        self._scan_stmts(list(ast.iter_child_nodes(info.node)), [],
                         info, modrel, relpath, funcs, cb_vars)

    def _scan_stmts(self, nodes, held: List[str], info: _FuncInfo,
                    modrel: str, relpath: str,
                    funcs: Dict[str, _FuncInfo], cb_vars: Set[str]):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue        # nested defs are scanned as their own funcs
            if isinstance(node, ast.With):
                acquired: List[str] = []
                for item in node.items:
                    lock_id = self._lock_of(item.context_expr, info)
                    if lock_id:
                        for h in held:
                            if h != lock_id:
                                self.edges.setdefault(
                                    (h, lock_id), (relpath, node.lineno))
                        acquired.append(lock_id)
                    else:
                        self._scan_expr(item.context_expr, held, info,
                                        modrel, relpath, funcs, cb_vars)
                self._scan_stmts(node.body, held + acquired, info,
                                 modrel, relpath, funcs, cb_vars)
                continue
            if isinstance(node, ast.For):
                self._scan_expr(node.iter, held, info, modrel, relpath,
                                funcs, cb_vars)
                new_cb = set(cb_vars)
                if self._iter_is_callbackish(node.iter):
                    for t in ast.walk(node.target):
                        if isinstance(t, ast.Name):
                            new_cb.add(t.id)
                self._scan_stmts(node.body + node.orelse, held, info,
                                 modrel, relpath, funcs, new_cb)
                continue
            # generic statement: scan expressions, recurse into blocks
            for fieldname, value in ast.iter_fields(node):
                if isinstance(value, list) and value \
                        and isinstance(value[0], ast.stmt):
                    self._scan_stmts(value, held, info, modrel, relpath,
                                     funcs, cb_vars)
                elif isinstance(value, ast.expr):
                    self._scan_expr(value, held, info, modrel, relpath,
                                    funcs, cb_vars)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.expr):
                            self._scan_expr(v, held, info, modrel,
                                            relpath, funcs, cb_vars)

    def _lock_of(self, expr: ast.AST, info: _FuncInfo) -> Optional[str]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and info.cls:
            return self.lock_attrs.get((info.cls, expr.attr))
        return None

    @staticmethod
    def _iter_is_callbackish(expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Attribute):
                low = n.attr.lower()
                if any(h in low for h in CALLBACK_HINTS):
                    return True
        return False

    # ------------------------------------------------------- expressions

    def _scan_expr(self, expr: ast.AST, held: List[str], info: _FuncInfo,
                   modrel: str, relpath: str,
                   funcs: Dict[str, _FuncInfo], cb_vars: Set[str]):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            self._check_call(node, held, info, modrel, relpath, funcs,
                             cb_vars)

    def _check_call(self, call: ast.Call, held: List[str],
                    info: _FuncInfo, modrel: str, relpath: str,
                    funcs: Dict[str, _FuncInfo], cb_vars: Set[str]):
        callee = _dotted(call.func) or ""
        base = callee.rsplit(".", 1)[-1]
        recv = callee.rsplit(".", 1)[0] if "." in callee else None
        under_lock = bool(held)
        blocking_ctx = under_lock or info.is_worker

        # CE003: time.sleep anywhere in engine code
        if callee in ("time.sleep", "sleep") and base == "sleep" \
                and (callee == "time.sleep" or recv is None):
            self._report("CE003", "time.sleep in engine code"
                         + (f" while holding {held[-1]}" if under_lock
                            else ""),
                         relpath, info, call)

        # CE002: callback invoked under a lock
        if under_lock:
            if callee.startswith("self.on_"):
                self._report("CE002",
                             f"user callback {callee} invoked while "
                             f"holding {held[-1]}", relpath, info, call)
            elif isinstance(call.func, ast.Name) \
                    and call.func.id in cb_vars:
                self._report("CE002",
                             f"callback variable {call.func.id}() "
                             f"invoked while holding {held[-1]}",
                             relpath, info, call)

        # CE004: timeout-less join in locked region / worker body
        if base == "join" and blocking_ctx and not _has_any_arg(call) \
                and recv not in (None, "os.path"):
            where = (f"while holding {held[-1]}" if under_lock
                     else "in worker body")
            self._report("CE004", f"timeout-less {callee}() {where}",
                         relpath, info, call)

        # CE005: timeout-less blocking queue op
        if base in ("put", "get") and blocking_ctx and _queueish(recv):
            positional_from = 1 if base == "put" else 0
            if not _has_timeout_kw(call, positional_from):
                where = (f"while holding {held[-1]}" if under_lock
                         else "in worker body")
                self._report("CE005",
                             f"blocking {callee}() without timeout "
                             f"{where}", relpath, info, call)

        # CE006: I/O under a lock
        if under_lock and (callee in IO_CALLS or base in ("urlopen",)):
            self._report("CE006",
                         f"I/O call {callee}() while holding {held[-1]}",
                         relpath, info, call)

        # CE007: timeout-less wait in worker body / locked region
        if base == "wait" and blocking_ctx and not _has_any_arg(call) \
                and recv is not None:
            where = (f"while holding {held[-1]}" if under_lock
                     else "in worker body")
            self._report("CE007", f"timeout-less {callee}() {where}",
                         relpath, info, call)

        # CE008: unnamed engine thread
        if base in ("Thread", "Timer") and callee.endswith(
                ("threading.Thread", "threading.Timer")) \
                or (base in ("Thread", "Timer") and callee == base):
            if not self._thread_is_named(call, info):
                self._report("CE008",
                             f"{base} constructed without a siddhi- "
                             f"name (core.threads.engine_thread_name)",
                             relpath, info, call)

        # one-level same-class call resolution: lock edges + CE002
        if callee.startswith("self.") and "." not in callee[5:] \
                and info.cls:
            target = funcs.get(f"{info.cls}.{callee[5:]}")
            if target is not None and under_lock:
                for lock_id, node in self._direct_acquires(target):
                    for h in held:
                        if h != lock_id:
                            self.edges.setdefault(
                                (h, lock_id), (relpath, call.lineno))
                if self._invokes_callbacks(target):
                    self._report(
                        "CE002",
                        f"{callee}() invokes user callbacks and is "
                        f"called while holding {held[-1]}",
                        relpath, info, call)

    def _direct_acquires(self, info: _FuncInfo):
        out = []
        for node in ast.walk(info.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    lock_id = self._lock_of(item.context_expr, info)
                    if lock_id:
                        out.append((lock_id, node))
        return out

    @staticmethod
    def _invokes_callbacks(info: _FuncInfo) -> bool:
        for node in ast.walk(info.node):
            if isinstance(node, ast.Call):
                callee = _dotted(node.func) or ""
                if callee.startswith("self.on_"):
                    return True
        return False

    @staticmethod
    def _thread_is_named(call: ast.Call, info: _FuncInfo) -> bool:
        if any(kw.arg == "name" for kw in call.keywords):
            return True
        # Timer has no name kwarg: accept a `<x>.name = ...` assignment
        # anywhere in the enclosing function (scheduler's pattern)
        for node in ast.walk(info.node):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and tgt.attr == "name":
                        return True
        return False

    def _report(self, code: str, message: str, relpath: str,
                info: _FuncInfo, node: ast.AST):
        key = (code, relpath, getattr(node, "lineno", 0))
        if key in self._reported:
            return
        self._reported.add(key)
        self.findings.append(EngineFinding(
            code=code, message=message, relpath=relpath,
            qualname=info.qualname, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0)))

    # ------------------------------------------------------------ finish

    def finish(self) -> List[EngineFinding]:
        """Cycle pass over the accumulated graph; returns all findings."""
        for cycle in self._cycles():
            relpath, line = self.edges.get(
                (cycle[0], cycle[1 % len(cycle)]), ("<graph>", 0))
            self.findings.append(EngineFinding(
                code="CE001",
                message="lock-order cycle: " + " -> ".join(
                    cycle + [cycle[0]]),
                relpath=relpath, qualname="<lock-graph>",
                line=line, col=0))
        return self.findings

    def _cycles(self) -> List[List[str]]:
        graph: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, []).append(b)
        seen_cycles: Set[Tuple[str, ...]] = set()
        out: List[List[str]] = []

        def dfs(node: str, stack: List[str], on_stack: Set[str]):
            for nxt in graph.get(node, ()):
                if nxt in on_stack:
                    i = stack.index(nxt)
                    cyc = stack[i:]
                    # canonical rotation for dedupe
                    k = min(range(len(cyc)),
                            key=lambda j: cyc[j])
                    canon = tuple(cyc[k:] + cyc[:k])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon))
                else:
                    stack.append(nxt)
                    on_stack.add(nxt)
                    dfs(nxt, stack, on_stack)
                    on_stack.discard(nxt)
                    stack.pop()

        for start in list(graph):
            dfs(start, [start], {start})
        return out


# ------------------------------------------------------------------ API


def _iter_engine_modules(root: Optional[str] = None):
    """Yield (text, modrel, relpath) for every engine source file.
    `modrel` is dotted relative to the package ('core.stream')."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    pkg_parent = os.path.dirname(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            relpath = os.path.relpath(full, pkg_parent)
            rel_in_pkg = os.path.relpath(full, root)
            modrel = rel_in_pkg[:-3].replace(os.sep, ".")
            if modrel.endswith(".__init__"):
                modrel = modrel[:-len(".__init__")]
            with open(full, encoding="utf-8") as f:
                yield f.read(), modrel, relpath.replace(os.sep, "/")


def audit_lock_graph(root: Optional[str] = None) -> LockGraphAuditor:
    auditor = LockGraphAuditor()
    for text, modrel, relpath in _iter_engine_modules(root):
        auditor.add_module(text, modrel, relpath)
    auditor.finish()
    return auditor


def static_lock_edges(root: Optional[str] = None) -> Set[Tuple[str, str]]:
    """The static acquisition-order edges, for core/lockwitness.py."""
    return set(audit_lock_graph(root).edges)


def analyze_module_source(text: str, modrel: str = "mod",
                          relpath: str = "mod.py") -> LockGraphAuditor:
    """Single-module entry point for unit tests."""
    auditor = LockGraphAuditor()
    auditor.add_module(text, modrel, relpath)
    auditor.finish()
    return auditor
