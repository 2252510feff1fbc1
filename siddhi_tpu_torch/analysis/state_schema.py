"""Static persistent-state schema analysis (``analyze --schema``).

Two complementary views of *what an app persists*, both derived without
executing any jax:

1. **Declaration scan** — an AST walk over siddhi_tpu_torch's own sources
   pairing every class that defines ``current_state`` with its
   ``@persistent_schema(...)`` declaration.  The decorator expression is
   evaluated in the :mod:`siddhi_tpu_torch.core.stateschema` namespace, so the
   static scan recovers the *exact* SchemaDecl (same digest) without
   importing the decorated — jax-laden — module.  A definer with no
   declaration is the SC002 lint finding; ``audit_declarations()`` is
   the tier-1 gate (tests/test_state_schema.py).

2. **App extraction** — :func:`extract_app_schema` mirrors the
   runtime's snapshot-element enumeration (core/runtime.py step 2-7 +
   QueryRuntime.stateful_elements) and the planner's routing rules
   (plan/planner.py plan_single_runtime / plan_state_runtime,
   dwin_compiler.DEVICE_KINDS) over the *parsed* app — per element id,
   which schema governs its snapshot section, on which engine path, and
   what the auto-mode host fallback would persist instead.  The stable
   text ``dump()`` is pinned per shipped sample under tests/golden/
   (REGEN_SCHEMA_GOLDEN=1), and its digest rides in tools/t1_report.py
   artifacts so schema drift without a version bump surfaces as a
   --compare regression (SC010's report-level twin).

The runtime-side view (:func:`extract_runtime_schema`, attached to
``rt.state_schema`` / ``rt.analysis.schema`` / GET /stats) describes the
*live* registered elements in cheap static mode — no current_state()
call, no device sync.

Everything here must stay importable without jax: the CLI contract
(tests assert ``analyze --schema`` keeps jax out of sys.modules) is the
whole point.
"""
from __future__ import annotations

import ast
import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from ..core import stateschema as _ss
from ..query_api import (Partition, Query, SiddhiApp, find_annotation)
from ..query_api.expression import AttributeFunction, Expression
from ..query_api.query import (JoinInputStream, SingleInputStream,
                               StateInputStream, WindowHandler)
from .analyzer import _engine_mode

# ======================================================== declaration scan

_SKIP_DIRS = {"__pycache__", "tests", "docs"}

def _decl_factory(name, *, version=1, schema=None, dims=None, doc=""):
    """Signature-compatible stand-in for the real decorator: yields the
    SchemaDecl directly, so evaluating a declaration never touches the
    import-time registry."""
    return _ss.SchemaDecl(name, version, schema, dims, doc)


#: names the decorator expressions may reference — the stateschema
#: module's public surface, nothing else (no builtins: a declaration is
#: data, not code)
_EVAL_NS = {k: getattr(_ss, k) for k in dir(_ss) if not k.startswith("_")}
_EVAL_NS["persistent_schema"] = _decl_factory


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _iter_sources(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _decorator_call(dec) -> Optional[ast.Call]:
    if isinstance(dec, ast.Call):
        f = dec.func
        name = f.id if isinstance(f, ast.Name) else \
            (f.attr if isinstance(f, ast.Attribute) else None)
        if name == "persistent_schema":
            return dec
    return None


def _eval_decl(call: ast.Call) -> _ss.SchemaDecl:
    """Evaluate one ``persistent_schema(...)`` decorator expression in
    the stateschema namespace — the resulting SchemaDecl is
    bit-identical (same digest) to what the import-time decorator
    registers, with none of the module's imports and no registry
    side effects."""
    expr = ast.Expression(body=call)
    ast.fix_missing_locations(expr)
    code = compile(expr, "<persistent-schema-decl>", "eval")
    return eval(code, {"__builtins__": {}}, dict(_EVAL_NS))  # noqa: S307


@dataclass
class DeclSite:
    """One class in the engine source relevant to persistent state."""
    module: str                         # dotted module path
    cls: str
    line: int
    decl: Optional[_ss.SchemaDecl]      # None → undecorated
    defines_state: bool                 # has its own def current_state

    @property
    def dotted(self) -> str:
        return f"{self.module}.{self.cls}"


def scan_declarations(root: Optional[str] = None) -> List[DeclSite]:
    """All classes that declare a schema and/or define current_state,
    in deterministic (path, line) order."""
    root = root or _package_root()
    pkg = os.path.basename(root.rstrip(os.sep))
    sites: List[DeclSite] = []
    for path in _iter_sources(root):
        rel = os.path.relpath(path, root)
        mod = pkg + "." + rel[:-3].replace(os.sep, ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        try:
            with open(path) as f:
                tree = ast.parse(f.read())
        except (SyntaxError, OSError):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            defines = any(
                isinstance(x, (ast.FunctionDef, ast.AsyncFunctionDef))
                and x.name == "current_state" for x in node.body)
            call = None
            for d in node.decorator_list:
                call = _decorator_call(d)
                if call is not None:
                    break
            if call is None and not defines:
                continue
            decl = _eval_decl(call) if call is not None else None
            sites.append(DeclSite(mod, node.name, node.lineno, decl,
                                  defines))
    return sites


def static_declarations(root: Optional[str] = None
                        ) -> Dict[str, _ss.SchemaDecl]:
    """dotted class name → SchemaDecl, from source alone (the static
    twin of core.stateschema.registry(), which fills at import time)."""
    return {s.dotted: s.decl for s in scan_declarations(root)
            if s.decl is not None}


def audit_declarations(allow: Tuple[str, ...] = (),
                       root: Optional[str] = None
                       ) -> List[Tuple[str, str]]:
    """SC002 lint: every class that defines ``current_state`` must carry
    its own ``@persistent_schema`` — a subclass overriding the hook
    inherits the base's *behaviour contract*, not its layout.  Returns
    one finding per violation; the tier-1 gate asserts the list is
    empty (allowlist deliberately starts empty)."""
    out = []
    for s in scan_declarations(root):
        if s.defines_state and s.decl is None and s.dotted not in allow:
            out.append((
                "SC002",
                f"{s.module}:{s.line}: class {s.cls} defines "
                f"current_state() but declares no @persistent_schema — "
                f"its snapshot sections cannot be verified at restore"))
    return out


def _decls_by_name(root: Optional[str] = None
                   ) -> Dict[str, _ss.SchemaDecl]:
    """schema name → SchemaDecl.  Two classes may share a name only if
    their layouts agree (host/device aggregation runtimes do, by
    design); a digest clash is itself a finding surfaced by dump()."""
    by_name: Dict[str, _ss.SchemaDecl] = {}
    decls = static_declarations(root)
    for dotted in sorted(decls):
        d = decls[dotted]
        by_name.setdefault(d.name, d)
    return by_name


# ========================================================= app extraction

#: window kinds whose host processor subclasses override current_state —
#: everything else persists the base WindowProcessor buffer
_HOST_WINDOW_DECLS = {
    "lengthbatch": "window-length-batch",
    "hopping": "window-hopping",
    "session": "window-session",
    "frequent": "window-frequent",
    "lossyfrequent": "window-frequent",
}

_KEYED_ENGINES = {
    "keyed-pattern": "nfa-engine",
    "keyed-window-agg": "wagg-engine",
    "keyed-grouped-agg": "gagg-engine",
}


def _host_window_decl(kind: str) -> str:
    return _HOST_WINDOW_DECLS.get(kind.lower(), "window-buffer")


def _device_window_kinds() -> Tuple[str, ...]:
    """dwin_compiler.DEVICE_KINDS without importing the (jax-laden)
    module: read off the AST, with a pinned fallback."""
    path = os.path.join(_package_root(), "plan", "dwin_compiler.py")
    try:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "DEVICE_KINDS"
                    for t in node.targets):
                return tuple(ast.literal_eval(node.value))
    except (OSError, SyntaxError, ValueError):
        pass
    return ("length", "lengthBatch", "time", "timeBatch", "externalTime",
            "externalTimeBatch", "timeLength", "delay", "batch", "sort",
            "session", "hopping")


def _has_aggregate(e) -> bool:
    """IR walk for aggregator calls (static twin of
    core.query_runtime._expr_has_aggregate — that module imports the
    planner, this one must not)."""
    from dataclasses import fields as dc_fields
    from dataclasses import is_dataclass

    from ..core.aggregator import is_aggregator
    if e is None:
        return False
    if isinstance(e, AttributeFunction) and \
            is_aggregator(e.namespace, e.name, len(e.args)):
        return True
    if isinstance(e, (list, tuple)):
        return any(_has_aggregate(x) for x in e)
    if is_dataclass(e) and isinstance(e, Expression):
        return any(_has_aggregate(getattr(e, f.name))
                   for f in dc_fields(e))
    return False


@dataclass
class ElementSchema:
    """One snapshot element the app will register, statically routed."""
    eid: str
    decl_name: str
    route: str                       # fixed | host | device | hybrid
    engine: Optional[str] = None     # nested engine decl for keyed slots
    fallback: Optional[str] = None   # what auto-mode falls back to
    note: str = ""
    children: List["ElementSchema"] = field(default_factory=list)

    def render(self, indent: str = "  ") -> List[str]:
        bits = [f"{indent}{self.eid} :: {self.decl_name}",
                f"route={self.route}"]
        if self.engine:
            bits.append(f"engine={self.engine}")
        if self.fallback:
            bits.append(f"fallback={self.fallback}")
        if self.note:
            bits.append(f"[{self.note}]")
        lines = [" ".join(bits)]
        for c in self.children:
            lines.extend(c.render(indent + "  "))
        return lines


@dataclass
class AppStateSchema:
    """The complete static persistent-state layout of one app."""
    app_name: str
    engine: str
    elements: List[ElementSchema]
    decls: Dict[str, _ss.SchemaDecl]
    findings: List[Tuple[str, str]] = field(default_factory=list)

    def _decl_names(self) -> List[str]:
        names = set()

        def walk(e: ElementSchema):
            names.add(e.decl_name)
            if e.engine:
                names.add(e.engine)
            if e.fallback:
                names.add(e.fallback)
            for c in e.children:
                walk(c)
        for e in self.elements:
            walk(e)
        return sorted(n for n in names if n in self.decls)

    def dump(self) -> str:
        """Stable textual render — the golden-file format."""
        lines = [f"app {self.app_name or '<unnamed>'}",
                 f"engine {self.engine}",
                 "elements:"]
        if not self.elements:
            lines.append("  (no persistent state)")
        for e in self.elements:
            lines.extend(e.render())
        lines.append("declarations:")
        for n in self._decl_names():
            d = self.decls[n]
            dims = ",".join(f"{k}:{v}" for k, v in d.dims.items())
            spec = "-" if d.schema is None else d.schema.spec()
            lines.append(f"  {n} v{d.version} digest={d.digest()} "
                         f"dims{{{dims}}} spec={spec}")
        for code, msg in self.findings:
            lines.append(f"finding {code}: {msg}")
        body = "\n".join(lines)
        return f"{body}\nschema-digest {_digest(body)}\n"

    def digest(self) -> str:
        return self.dump().rstrip("\n").rsplit(" ", 1)[-1]

    def versions(self) -> Dict[str, int]:
        """declaration name → version, for drift-vs-bump comparisons."""
        return {n: self.decls[n].version for n in self._decl_names()}

    def as_dict(self) -> dict:
        def el(e: ElementSchema) -> dict:
            d = {"eid": e.eid, "schema": e.decl_name, "route": e.route}
            if e.engine:
                d["engine"] = e.engine
            if e.fallback:
                d["fallback"] = e.fallback
            if e.note:
                d["note"] = e.note
            if e.children:
                d["children"] = [el(c) for c in e.children]
            return d
        return {"app": self.app_name, "engine": self.engine,
                "digest": self.digest(),
                "elements": [el(e) for e in self.elements],
                "declarations": {n: self.decls[n].as_dict()
                                 for n in self._decl_names()},
                "findings": [{"code": c, "message": m}
                             for c, m in self.findings]}


def _digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def _window_elements(qname: str, handlers, engine: str,
                     device_kinds: Tuple[str, ...]) -> List[ElementSchema]:
    """One ``{qname}:window:{i}`` element per WindowHandler, routed to
    the device window kernel when the kind has device lanes (the dwin
    hybrid keeps the selector host-side either way)."""
    out = []
    i = 0
    for h in handlers:
        if not isinstance(h, WindowHandler):
            continue
        host_decl = _host_window_decl(h.name)
        if engine != "host" and not h.namespace and h.name in device_kinds:
            out.append(ElementSchema(
                f"{qname}:window:{i}", "device-window", "hybrid",
                fallback=host_decl if engine == "auto" else None,
                note="payload types decide at plan time"
                if engine == "auto" else ""))
        else:
            out.append(ElementSchema(f"{qname}:window:{i}", host_decl,
                                     "host"))
        i += 1
    return out


def _query_elements(q: Query, qname: str, engine: str,
                    device_kinds: Tuple[str, ...],
                    in_partition: bool,
                    attr_types: Optional[dict] = None) -> List[ElementSchema]:
    ins = q.input_stream
    els: List[ElementSchema] = []

    if isinstance(ins, StateInputStream):
        if in_partition or engine != "host":
            e = ElementSchema(f"{qname}:state", "keyed-pattern",
                              "device", engine=_KEYED_ENGINES["keyed-pattern"])
            if engine == "auto" and not in_partition:
                e.fallback = "host-pattern"
            els.append(e)
            if engine == "auto" and not in_partition:
                els.append(ElementSchema(
                    f"{qname}:selector", "selector", "host",
                    note="host fallback only"))
        else:
            els.append(ElementSchema(f"{qname}:selector", "selector",
                                     "host"))
            els.append(ElementSchema(f"{qname}:state", "host-pattern",
                                     "host"))
        return els

    if isinstance(ins, JoinInputStream):
        els.append(ElementSchema(f"{qname}:selector", "selector", "host"))
        i = 0
        for side in (ins.left, ins.right):
            handlers = getattr(side, "handlers", None) or []
            for h in handlers:
                if isinstance(h, WindowHandler):
                    els.append(ElementSchema(
                        f"{qname}:join:{i}", _host_window_decl(h.name),
                        "host"))
                    i += 1
                    break       # one window of record per join side
        return els

    if not isinstance(ins, SingleInputStream):
        return els

    handlers = ins.handlers or []
    has_window = any(isinstance(h, WindowHandler) for h in handlers)
    sel = q.selector
    has_agg = any(_has_aggregate(oa.expr) for oa in sel.attributes) or \
        (sel.having is not None and _has_aggregate(sel.having))
    grouped = bool(sel.group_by)

    if in_partition:
        # keyed device mode: window-ring kernel first, grouped-agg slabs
        # as the in-constructor fallback (query_runtime.py keyed branch)
        if has_window or has_agg or grouped:
            primary = "keyed-window-agg" if has_window else \
                "keyed-grouped-agg"
            e = ElementSchema(f"{qname}:state", primary, "device",
                              engine=_KEYED_ENGINES[primary])
            if primary == "keyed-window-agg":
                e.fallback = "keyed-grouped-agg"
                e.note = "ring kernel first, grouped-agg slabs otherwise"
            els.append(e)
        else:
            els.append(ElementSchema(f"{qname}:state", "device-filter",
                                     "device", note="stateless"))
        return els

    if engine == "host":
        els.append(ElementSchema(f"{qname}:selector", "selector", "host"))
        els.extend(_window_elements(qname, handlers, engine, device_kinds))
        return els

    dwin_shape = has_window and not has_agg and not grouped
    if dwin_shape:
        # plain projection over a window: dwin hybrid owns this shape
        # (plan_single_runtime declines it so the device window can take
        # the buffer while the selector stays host)
        els.append(ElementSchema(f"{qname}:selector", "selector", "host"))
        els.extend(_window_elements(qname, handlers, engine, device_kinds))
        return els
    if has_window or has_agg or grouped:
        e = ElementSchema(f"{qname}:state", "keyed-grouped-agg", "device",
                          engine=_KEYED_ENGINES["keyed-grouped-agg"])
        if engine == "auto":
            e.fallback = "selector"
            e.note = "host fallback persists selector + windows"
        els.append(e)
        if engine == "auto":
            # selection-active queries: the static expressibility gate
            # (plan/select_compiler) says whether the having/order/limit
            # tail rides the device egress kernel or definitely engages
            # the host selector fallback
            note = "host fallback only"
            from ..plan.select_compiler import classify_selection
            dec = classify_selection(q, attr_types or {},
                                     in_partition=in_partition)
            if dec.active and not dec.device:
                note = f"host-pinned selection: {dec.reason}"
            els.append(ElementSchema(f"{qname}:selector", "selector",
                                     "host", note=note))
            els.extend(_window_elements(qname, handlers, "host",
                                        device_kinds))
        return els
    e = ElementSchema(f"{qname}:state", "device-filter", "device",
                      note="stateless")
    if engine == "auto":
        e.fallback = "selector"
        els.append(e)
        els.append(ElementSchema(f"{qname}:selector", "selector", "host",
                                 note="host fallback only"))
    else:
        els.append(e)
    return els


def extract_app_schema(app: Union[str, SiddhiApp],
                       engine: Optional[str] = None) -> AppStateSchema:
    """Statically derive the complete persistent-state layout of one
    app: every snapshot element id the runtime will register, the schema
    declaration governing its section, and the engine path that decides
    between device and host layouts.  Never imports jax."""
    if isinstance(app, str):
        from ..compiler import SiddhiCompiler
        app = SiddhiCompiler.parse(app)
    engine = engine or _engine_mode(app)
    decls = _decls_by_name()
    device_kinds = _device_window_kinds()
    els: List[ElementSchema] = []
    findings: List[Tuple[str, str]] = []

    for tid, td in sorted(app.table_definitions.items()):
        store = find_annotation(td.annotations, "store")
        name = "record-table" if store is not None else "table"
        els.append(ElementSchema(f"table:{tid}", name, "fixed"))
    for wid, wd in sorted(app.window_definitions.items()):
        kind = wd.window_name or "length"
        els.append(ElementSchema(
            f"window:{wid}", "named-window", "fixed",
            engine=_host_window_decl(kind),
            note=f"wraps #window.{kind}"))
    for aid in sorted(app.aggregation_definitions):
        els.append(ElementSchema(
            f"aggregation:{aid}", "aggregation", "fixed",
            note="host and device ingest share one layout"))

    def _attr_types_for(q: Query) -> dict:
        ins = q.input_stream
        sid = getattr(ins, "stream_id", None)
        d = app.stream_definitions.get(sid) if sid else None
        return {a.name: a.type for a in d.attributes} \
            if d is not None else {}

    qcount = 0
    for el in app.execution_elements:
        if isinstance(el, Query):
            qname = el.name or f"query_{qcount}"
            els.extend(_query_elements(el, qname, engine, device_kinds,
                                       in_partition=False,
                                       attr_types=_attr_types_for(el)))
        elif isinstance(el, Partition):
            pname = f"partition_{qcount}"
            p = ElementSchema(f"partition:{pname}", "partition", "fixed",
                              note="device mode nests per-query "
                                   "sections; host mode keeps a per-key "
                                   "instance map")
            if engine != "host":
                for qi, q in enumerate(el.queries):
                    qname = q.name or f"{pname}_query_{qi}"
                    p.children.extend(_query_elements(
                        q, qname, engine, device_kinds,
                        in_partition=True,
                        attr_types=_attr_types_for(q)))
            els.append(p)
        qcount += 1

    for e in els:
        for n in filter(None, (e.decl_name, e.engine, e.fallback)):
            if n not in decls:
                findings.append((
                    "SC002",
                    f"{e.eid}: no @persistent_schema declaration named "
                    f"'{n}' exists in the engine source"))
    return AppStateSchema(app.name, engine, els, decls, findings)


# ====================================================== runtime-side view

@dataclass
class StateSchemaReport:
    """The live runtime's registered snapshot elements, each described
    in cheap static mode (no current_state() call, no device sync)."""
    app_name: str
    routing: Optional[str]
    elements: Dict[str, dict]
    findings: List[Tuple[str, str]] = field(default_factory=list)

    def digest(self) -> str:
        rows = []
        for eid in sorted(self.elements):
            d = self.elements[eid]
            rows.append(f"{eid}|{d.get('name')}|{d.get('version')}|"
                        f"{d.get('digest')}")
        return _digest("\n".join(rows))

    def versions(self) -> Dict[str, int]:
        return {d["name"]: d["version"]
                for d in self.elements.values() if d.get("name")}

    def as_dict(self) -> dict:
        return {"app": self.app_name, "routing": self.routing,
                "digest": self.digest(),
                "elements": {eid: {k: v for k, v in d.items()
                                   if k != "findings"}
                             for eid, d in sorted(self.elements.items())},
                "findings": [{"code": c, "message": m}
                             for c, m in self.findings]}

    def render(self) -> str:
        lines = [f"app {self.app_name}: {len(self.elements)} persistent "
                 f"element(s), schema digest {self.digest()}"
                 + (f", routing {self.routing}" if self.routing else "")]
        for eid in sorted(self.elements):
            d = self.elements[eid]
            lines.append(f"  {eid} :: {d.get('name')} "
                         f"v{d.get('version')} {d.get('digest')}")
        for c, m in self.findings:
            lines.append(f"  {c}: {m}")
        return "\n".join(lines)


def extract_runtime_schema(rt) -> StateSchemaReport:
    """Describe every element registered with ``rt``'s snapshot service
    (static mode — safe at creation time, before any event flows)."""
    svc = rt.snapshot_service
    elements: Dict[str, dict] = {}
    findings: List[Tuple[str, str]] = []
    for eid, el in svc._elements.items():
        d = _ss.describe_element(el)
        if d is None:
            continue
        for code, msg in d.get("findings", []) or []:
            findings.append((code, f"{eid}: {msg}"))
        elements[eid] = d
    return StateSchemaReport(getattr(rt, "name", "<app>"),
                             svc._routing(), elements, findings)


def attach_schema_analysis(rt, strict: bool = False) -> StateSchemaReport:
    """Compute the live schema report and hang it off the runtime
    (``rt.state_schema`` always; ``rt.analysis.schema`` when the
    semantic-analysis result is attached).  Under ``strict``, any SC002
    finding — an element whose snapshot section cannot be verified —
    raises."""
    report = extract_runtime_schema(rt)
    rt.state_schema = report
    analysis = getattr(rt, "analysis", None)
    if analysis is not None:
        analysis.schema = report
    if strict and report.findings:
        from ..utils.errors import SiddhiAppValidationException
        raise SiddhiAppValidationException(
            "persistent-state schema audit found "
            f"{len(report.findings)} problem(s):\n" +
            "\n".join(f"  {c}: {m}" for c, m in report.findings))
    return report


# ============================================================ sample sweep

def apps_in_source(path: str) -> List[List[str]]:
    """SiddhiQL app literals embedded in a sample .py — plain strings
    verbatim; f-string slots tried as '0' then '' keeping whichever
    variant parses (same extraction as tests/test_plan_golden.py)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    apps = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if "define stream" in node.value and ";" in node.value:
                apps.append([node.value])
        elif isinstance(node, ast.JoinedStr):
            variants = []
            for filler in ("0", ""):
                text = "".join(str(v.value) if isinstance(v, ast.Constant)
                               else filler for v in node.values)
                variants.append(text)
            if "define stream" in variants[0] and ";" in variants[0]:
                apps.append(variants)
    return [v for v in apps
            if not any(v is not w and v[0] in w[0] for w in apps)]


def schema_of_variants(variants: List[str]) -> AppStateSchema:
    """First parseable variant → its AppStateSchema."""
    last: Optional[Exception] = None
    for text in variants:
        try:
            return extract_app_schema(text)
        except Exception as e:      # noqa: BLE001 — try the next variant
            last = e
    raise last if last is not None else ValueError("no variants")


def sample_schema_digests(samples_dir: str) -> Dict[str, List[dict]]:
    """Per shipped sample, the static schema digest + declaration
    versions of every embedded app — the t1_report artifact rows that
    let ``--compare`` flag schema drift without a version bump."""
    out: Dict[str, List[dict]] = {}
    for fname in sorted(os.listdir(samples_dir)):
        if not fname.endswith(".py"):
            continue
        rows = []
        for variants in apps_in_source(os.path.join(samples_dir, fname)):
            try:
                s = schema_of_variants(variants)
            except Exception:       # noqa: BLE001 — unparseable sample
                continue
            rows.append({"app": s.app_name or "<unnamed>",
                         "digest": s.digest(),
                         "versions": s.versions()})
        if rows:
            out[fname] = rows
    return out


def selection_coverage_of(app_source: str) -> List[dict]:
    """Per selection-active query of one app, the static routing verdict
    of the selection tail (having / order-by / limit / offset): device
    egress kernel or host ``QuerySelector`` with the blocking reason.
    Never imports jax."""
    from ..compiler import SiddhiCompiler
    from ..plan.select_compiler import classify_selection
    app = SiddhiCompiler.parse(app_source)

    def _attr_types_for(q: Query) -> dict:
        sid = getattr(q.input_stream, "stream_id", None)
        d = app.stream_definitions.get(sid) if sid else None
        return {a.name: a.type for a in d.attributes} \
            if d is not None else {}

    rows: List[dict] = []
    qcount = 0

    def _visit(q: Query, qname: str, in_partition: bool) -> None:
        dec = classify_selection(q, _attr_types_for(q),
                                 in_partition=in_partition)
        if not dec.active:
            return
        row = {"query": qname,
               "backend": "device" if dec.device else "host"}
        if not dec.device:
            row["reason"] = dec.reason
        rows.append(row)

    for el in app.execution_elements:
        if isinstance(el, Query):
            _visit(el, el.name or f"query_{qcount}", in_partition=False)
        elif isinstance(el, Partition):
            for qi, q in enumerate(el.queries):
                qname = q.name or f"partition_{qcount}_query_{qi}"
                _visit(q, qname, in_partition=True)
        qcount += 1
    return rows


def sample_selection_coverage(samples_dir: str) -> Dict[str, dict]:
    """Per shipped sample, counts of selection-active queries routed to
    the device egress kernel vs pinned on the host selector — the
    t1_report artifact rows that let ``--compare`` flag a silent
    regression from device selection back to host."""
    out: Dict[str, dict] = {}
    for fname in sorted(os.listdir(samples_dir)):
        if not fname.endswith(".py"):
            continue
        device = 0
        host = 0
        details: List[dict] = []
        for variants in apps_in_source(os.path.join(samples_dir, fname)):
            rows = None
            for text in variants:
                try:
                    rows = selection_coverage_of(text)
                    break
                except Exception:   # noqa: BLE001 — try the next variant
                    continue
            for row in rows or []:
                if row["backend"] == "device":
                    device += 1
                else:
                    host += 1
                details.append(row)
        out[fname] = {"device": device, "host": host,
                      "queries": details}
    return out
