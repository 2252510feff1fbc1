"""Persistent-state schema registry: the typed model behind SC0xx.

Every ``current_state()`` implementer declares *what it persists* with
one class decorator::

    @persistent_schema("nfa-engine", version=1,
                       schema=Struct(carry=Carry(), base_ts=Scalar("opt_int"),
                                     n_partitions=Scalar("int"),
                                     str_decoder=ListOf("str")),
                       dims={"S": "exact", "K": "ladder", "P": "free",
                             "R": "exact", "C": "exact"})
    class CompiledPatternNFA: ...

The declaration is a tiny node language (:class:`Struct`, :class:`Carry`,
:class:`Scalar`, ...) whose canonical render is digested into a stable
schema fingerprint.  ``SnapshotService`` embeds each element's
*description* (name, version, digest, live dim values, resolved carry
leaves) in the snapshot envelope at persist time, and
:func:`verify_compat` diffs the embedded descriptions against the live
runtime's BEFORE any ``restore_state`` runs — so an incompatible restore
is a typed ``CannotRestoreStateError`` naming an SC0xx code and the
field-level diff, never a jax shape error three frames deep.

Dim kinds are the compatibility policy:

  ``exact``   plan-determined (NFA state count S, capture rows R) —
              restore requires equality;
  ``ladder``  elastic by power-of-two growth (key-lane capacity K) —
              snapshot and live values must differ by an integer 2^n
              factor (SC004 otherwise);
  ``free``    adopted wholesale by restore_state (partition lanes P,
              ring capacity) — never compared;
  ``shards``  the per-shard section count — must match exactly and is
              tied to the pinned FNV-1a routing digest (SC005).

Like core/hotpath.py, the decorator is a zero-cost marker feeding two
consumers: the runtime registry here (snapshot envelopes, restore
verification) and the static AST scan in analysis/state_schema.py
(``analyze --schema``, jax-free).  This module itself must stay
importable without jax: numpy + hashlib only.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar

import numpy as np

C = TypeVar("C", bound=type)

#: sentinel distinguishing "declared field absent from payload" from None
_ABSENT = object()

SCHEMA_ENVELOPE_VERSION = 2


# ============================================================== node language

class SchemaNode:
    """Base of the declaration language.  ``spec()`` is the canonical
    static render (digested); ``resolve()`` flattens a live payload into
    ``path -> descriptor`` strings for field-level diffs."""

    def spec(self) -> str:
        raise NotImplementedError

    def resolve(self, payload, path: str, out: Dict[str, str],
                findings: List[Tuple[str, str]], decl_name: str) -> None:
        raise NotImplementedError

    def __repr__(self):
        return self.spec()


class Scalar(SchemaNode):
    """A host-side scalar slot.  Renders from the *declared* kind, never
    the live value — an Optional[int] that happens to be None at persist
    time must not diff against one that holds 7."""

    def __init__(self, kind: str):
        self.kind = kind

    def spec(self):
        return self.kind

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = self.kind


class Chunk(SchemaNode):
    """A serialized EventChunk (columnar buffers dict)."""

    def spec(self):
        return "chunk"

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = "chunk"


class Opt(SchemaNode):
    def __init__(self, inner: SchemaNode):
        self.inner = inner

    def spec(self):
        return f"opt<{self.inner.spec()}>"

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = f"opt<{self.inner.spec()}>"


class ListOf(SchemaNode):
    def __init__(self, kind: str):
        self.kind = kind

    def spec(self):
        return f"list<{self.kind}>"

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = f"list<{self.kind}>"


class MapOf(SchemaNode):
    def __init__(self, kind: str):
        self.kind = kind

    def spec(self):
        return f"map<{self.kind}>"

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = f"map<{self.kind}>"


class Carry(SchemaNode):
    """A dict of named device arrays (the jitted step's carry).  Leaves
    resolve LIVE — name set and dtypes come from the actual payload, so
    a telemetry-plane toggle or a dtype change shows up as a field diff
    (SC001), while shapes are covered by the dim table instead."""

    def spec(self):
        return "carry{...}"

    def resolve(self, payload, path, out, findings, decl_name):
        if payload is _ABSENT or payload is None:
            out[path] = "carry{...}"       # static mode / missing slot
            return
        if not isinstance(payload, dict):
            out[path] = f"carry!{type(payload).__name__}"
            return
        for k in sorted(payload):
            a = np.asarray(payload[k])
            out[f"{path}.{k}"] = f"ndarray<{a.dtype},ndim={a.ndim}>"


class CarryTuple(SchemaNode):
    """A NamedTuple carry persisted as a positional list of arrays —
    leaves resolve live by index (plane count + dtype diffs)."""

    def spec(self):
        return "carry[...]"

    def resolve(self, payload, path, out, findings, decl_name):
        if payload is _ABSENT or payload is None:
            out[path] = "carry[...]"
            return
        if not isinstance(payload, (list, tuple)):
            out[path] = f"carry!{type(payload).__name__}"
            return
        for i, v in enumerate(payload):
            a = np.asarray(v)
            out[f"{path}.{i}"] = f"ndarray<{a.dtype},ndim={a.ndim}>"


class Struct(SchemaNode):
    """A dict payload with a fixed field set."""

    def __init__(self, **fields: SchemaNode):
        self.fields = dict(sorted(fields.items()))

    def spec(self):
        inner = ",".join(f"{k}:{v.spec()}" for k, v in self.fields.items())
        return f"{{{inner}}}"

    def resolve(self, payload, path, out, findings, decl_name):
        pay = payload if isinstance(payload, dict) else None
        for k, sub in self.fields.items():
            p = f"{path}.{k}" if path else k
            v = _ABSENT if pay is None else pay.get(k, _ABSENT)
            sub.resolve(v, p, out, findings, decl_name)
        if pay is not None:
            for k in pay:
                if k not in self.fields:
                    p = f"{path}.{k}" if path else k
                    out[p] = "undeclared"
                    findings.append((
                        "SC002",
                        f"payload key '{k}' is not described by schema "
                        f"'{decl_name}' — the declaration is stale"))


class Sub(SchemaNode):
    """Delegate the whole description to a decorated sub-object (e.g.
    NamedWindow persists exactly its wrapped window processor's state)."""

    def __init__(self, attr: str):
        self.attr = attr

    def spec(self):
        return f"sub<{self.attr}>"

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = f"sub<{self.attr}>"


class Keyed(SchemaNode):
    """A keyed device runtime's payload: either one flat
    ``{field: engine_state, key_lanes}`` slab or a per-shard list
    ``{"shards": [{field, key_lanes}, ...]}`` keyed by the pinned FNV-1a
    routing.  The shard count becomes the ``shards`` dim (kind
    ``shards`` → SC005 on mismatch) and the engine's own description
    nests under ``sub``."""

    def __init__(self, field: str):
        self.field = field

    def spec(self):
        return f"keyed<{self.field}>"

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = f"keyed<{self.field}>"


class PartitionState(SchemaNode):
    """PartitionRuntime payload: device mode persists per-query element
    states (each described by its own schema, nested under ``sub`` keyed
    ``qname/eid``); host mode persists a dynamic per-key instance map."""

    def spec(self):
        return "partition"

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = "partition"


class Any_(SchemaNode):
    """Escape hatch: structure intentionally undeclared; the SC003
    portable-payload scan still applies."""

    def spec(self):
        return "any"

    def resolve(self, payload, path, out, findings, decl_name):
        out[path] = "any"


# ============================================================== declarations

class SchemaDecl:
    """One class's declared persistent-state schema."""

    def __init__(self, name: str, version: int, schema: Optional[SchemaNode],
                 dims: Dict[str, str], doc: str = ""):
        self.name = name
        self.version = version
        self.schema = schema
        self.dims = dict(sorted((dims or {}).items()))
        self.doc = doc

    def digest(self) -> str:
        """Stable fingerprint of the declared layout (name + node spec +
        dim kinds).  Version is deliberately excluded: SC010 is exactly
        'digest moved while version did not'."""
        spec = "-" if self.schema is None else self.schema.spec()
        dims = ",".join(f"{k}:{v}" for k, v in self.dims.items())
        raw = f"{self.name}|{spec}|{dims}"
        return hashlib.sha256(raw.encode()).hexdigest()[:12]

    def as_dict(self) -> dict:
        return {"name": self.name, "version": self.version,
                "digest": self.digest(),
                "spec": "-" if self.schema is None else self.schema.spec(),
                "dims": dict(self.dims)}

    def __repr__(self):
        return (f"SchemaDecl({self.name!r}, v{self.version}, "
                f"{self.digest()})")


#: dotted class name -> SchemaDecl, filled at import time by decorators.
_REGISTRY: Dict[str, SchemaDecl] = {}


def persistent_schema(name: str, *, version: int = 1,
                      schema: Optional[SchemaNode],
                      dims: Optional[Dict[str, str]] = None,
                      doc: str = "") -> Callable[[C], C]:
    """Class decorator declaring what the class's ``current_state()``
    persists.  ``schema=None`` declares the class stateless (its
    current_state returns None).  Zero runtime cost — registers the
    declaration and hands the class back untouched; the static scan in
    analysis/state_schema.py re-derives the exact same declaration from
    the AST without importing the decorated (jax-laden) module."""
    decl = SchemaDecl(name, version, schema, dims, doc)

    def mark(cls: C) -> C:
        cls.__state_schema__ = decl
        _REGISTRY[f"{cls.__module__}.{cls.__qualname__}"] = decl
        return cls
    return mark


def registry() -> Dict[str, SchemaDecl]:
    return dict(_REGISTRY)


def decl_of(cls: type) -> Tuple[Optional[SchemaDecl], Optional[type]]:
    """The SchemaDecl governing ``cls``'s persistent state: the one
    declared ON the class that *defines* current_state in the MRO.  A
    subclass overriding current_state without its own declaration is
    undeclared (SC002) even if a base is decorated — the override may
    persist a different payload."""
    for c in cls.__mro__:
        if "current_state" in c.__dict__:
            return c.__dict__.get("__state_schema__"), c
    return None, None


# ======================================================= portable-payload scan

#: leaf types a snapshot payload may contain and remain restorable by any
#: build of the engine (SC003 otherwise): plain data, no live objects.
_PORTABLE_LEAVES = (np.ndarray, np.generic, int, float, complex, str,
                    bool, bytes, bytearray, type(None))

_SCAN_CAP = 20000     # bounded walk: snapshots can be large


def portable_scan(payload: Any, path: str = "") -> List[Tuple[str, str]]:
    """Walk a payload and flag values that would raw-pickle a class
    instance (restorable only by the exact same build — SC003)."""
    findings: List[Tuple[str, str]] = []
    budget = [_SCAN_CAP]

    def walk(v, p):
        if budget[0] <= 0:
            return
        budget[0] -= 1
        if isinstance(v, _PORTABLE_LEAVES):
            return
        if isinstance(v, dict):
            for k, x in v.items():
                walk(x, f"{p}.{k}" if p else str(k))
            return
        if isinstance(v, (list, tuple, set, frozenset)):
            for i, x in enumerate(v):
                walk(x, f"{p}[{i}]")
            return
        t = type(v)
        findings.append((
            "SC003",
            f"field '{p or '<root>'}' holds a raw {t.__module__}."
            f"{t.__qualname__} instance — non-portable pickle payload "
            f"(only plain data and ndarrays survive engine rebuilds)"))
    walk(payload, path)
    return findings


# ============================================================== descriptions

def _live_dims(el) -> Dict[str, Any]:
    fn = getattr(el, "schema_dims", None)
    if fn is None:
        return {}
    try:
        return {k: v for k, v in fn().items()}
    except Exception:     # noqa: BLE001 — a dim probe must never
        return {}         # take down persist/describe


def describe_element(el, payload=_ABSENT) -> Optional[dict]:
    """Describe one element's persistent state: the declaration resolved
    against a live payload (persist/restore time) or statically
    (``payload`` omitted — the cheap creation-time report path).
    Returns None for declared-stateless elements."""
    decl, owner = decl_of(type(el))
    cls = type(el)
    if decl is None:
        return {"name": f"{cls.__module__}.{cls.__qualname__}",
                "version": 0, "digest": "", "dims": {}, "dimkinds": {},
                "fields": {}, "sub": None,
                "findings": [(
                    "SC002",
                    f"{cls.__module__}.{cls.__qualname__} defines "
                    f"current_state but declares no persistent schema")]}
    if decl.schema is None:
        return None
    node = decl.schema
    if isinstance(node, Sub):
        target = getattr(el, node.attr, None)
        if target is None:
            return None
        return describe_element(target, payload)
    findings: List[Tuple[str, str]] = []
    sub = None
    fields: Dict[str, str] = {}
    dims = _live_dims(el)
    if isinstance(node, Keyed):
        sub, nshards = _describe_keyed(el, node, payload)
        dims["shards"] = nshards
        fields["key_lanes"] = "map<key,lane>"
        dimkinds = dict(decl.dims)
        dimkinds["shards"] = "shards"
    elif isinstance(node, PartitionState):
        sub = _describe_partition(el, payload)
        dimkinds = dict(decl.dims)
        if sub is None:
            fields["keys"] = "map<key,query-state>"
    else:
        node.resolve(None if payload is _ABSENT else payload, "",
                     fields, findings, decl.name)
        dimkinds = dict(decl.dims)
    if payload is not _ABSENT and payload is not None:
        findings.extend(portable_scan(payload))
    return {"name": decl.name, "version": decl.version,
            "digest": decl.digest(), "dims": dims, "dimkinds": dimkinds,
            "fields": fields, "sub": sub, "findings": findings}


def _describe_keyed(el, node: Keyed, payload):
    """(engine sub-description, shard count) for a keyed runtime."""
    live_shards = getattr(el, "shards", None)
    if payload is _ABSENT:                 # static mode: live topology
        if live_shards:
            return (describe_element(live_shards[0].engine),
                    len(live_shards))
        engine = getattr(el, node.field, None)
        return (None if engine is None else describe_element(engine), 0)
    if not isinstance(payload, dict):
        return None, 0
    snap_shards = payload.get("shards")
    if snap_shards is not None:
        engine = (live_shards[0].engine if live_shards
                  else getattr(el, node.field, None))
        sub = None
        if engine is not None and snap_shards:
            sub = describe_element(engine, snap_shards[0].get(node.field))
        return sub, len(snap_shards)
    engine = getattr(el, node.field, None)
    if engine is None:
        return None, 0
    return describe_element(engine, payload.get(node.field)), 0


def _describe_partition(el, payload):
    """Device-mode partitions nest one description per ``qname/eid``;
    host mode returns None (dynamic per-key instances, fields only)."""
    device = (getattr(el, "device_mode", False) if payload is _ABSENT
              else isinstance(payload, dict) and "device" in payload)
    if not device:
        return None
    sub: Dict[str, dict] = {}
    for qname, qr in getattr(el, "device_query_runtimes", {}).items():
        section = (_ABSENT if payload is _ABSENT
                   else (payload.get("device", {}) or {}).get(qname, {}))
        for eid, obj in qr.stateful_elements():
            slice_ = (section if section is _ABSENT
                      else section.get(eid, _ABSENT))
            d = describe_element(obj, slice_)
            if d is not None:
                sub[f"{qname}/{eid}"] = d
    return sub


# ============================================================== verification

def _on_ladder(a, b) -> bool:
    """True when a and b differ by an integer power-of-two factor (the
    grow ladder doubles capacity; any legitimate pair of snapshots of
    the same app sits a 2^n ratio apart)."""
    try:
        a, b = int(a), int(b)
    except (TypeError, ValueError):
        return a == b
    if a <= 0 or b <= 0:
        return a == b
    lo, hi = min(a, b), max(a, b)
    if hi % lo:
        return False
    r = hi // lo
    return (r & (r - 1)) == 0


def shard_mismatch_message(have: int, want: int,
                           digest: Optional[str] = None) -> str:
    """Shared SC005 text: the planner's restore guard and the envelope
    verifier must tell the same story (expected-vs-found counts + the
    pinned routing digest the key→shard assignment hangs off)."""
    if digest is None:
        try:
            from ..parallel.shards import routing_digest
            digest = routing_digest()
        except Exception:     # noqa: BLE001 — message helper
            digest = "?"
    return (f"sharded snapshot carries {want} shard slab(s) but the "
            f"runtime has {have} — key→shard routing is modular in the "
            f"shard count (FNV-1a routing digest {digest}); restore "
            f"requires the same SIDDHI_TPU_SHARDS the snapshot was "
            f"taken with")


def compare_descriptions(eid: str, snap: Optional[dict],
                         live: Optional[dict],
                         findings: List[Tuple[str, str]]) -> None:
    """Field-level diff of one element's snapshot vs live description."""
    if snap is None or live is None:
        return
    for f in snap.get("findings", []) or []:
        if f[0] == "SC003":
            findings.append((f[0], f"{eid}: {f[1]}"))
    if snap.get("name") != live.get("name"):
        findings.append((
            "SC001", f"{eid}: snapshot persists schema "
            f"'{snap.get('name')}' but the live element declares "
            f"'{live.get('name')}' — the element was planned onto a "
            f"different engine path"))
        return
    if snap.get("version") != live.get("version"):
        findings.append((
            "SC001", f"{eid}: schema '{snap.get('name')}' version "
            f"{snap.get('version')} (snapshot) vs {live.get('version')} "
            f"(live) — declared evolution requires migration, not a "
            f"raw restore"))
        return
    if snap.get("digest") != live.get("digest"):
        findings.append((
            "SC010", f"{eid}: schema '{snap.get('name')}' "
            f"v{snap.get('version')} layout digest {snap.get('digest')} "
            f"(snapshot) vs {live.get('digest')} (live) — the layout "
            f"changed without a version bump"))
    kinds = dict(snap.get("dimkinds", {}) or {})
    kinds.update(live.get("dimkinds", {}) or {})
    sd = snap.get("dims", {}) or {}
    ld = live.get("dims", {}) or {}
    for d in sorted(set(sd) | set(ld)):
        kind = kinds.get(d, "exact")
        a, b = sd.get(d), ld.get(d)
        if a is None or b is None or kind == "free":
            continue
        if kind == "exact":
            if a != b:
                findings.append((
                    "SC001", f"{eid}: dim {d}={a} (snapshot) vs "
                    f"{d}={b} (live) — fixed by the plan, restore "
                    f"requires equality"))
        elif kind == "ladder":
            if not _on_ladder(a, b):
                findings.append((
                    "SC004", f"{eid}: elastic dim {d}={a} (snapshot) "
                    f"vs {d}={b} (live) is off the grow ladder — "
                    f"capacities grow by doubling, so compatible "
                    f"values differ by a power-of-two factor"))
        elif kind == "shards":
            if a != b:
                findings.append(("SC005",
                                 f"{eid}: " +
                                 shard_mismatch_message(b, a)))
    sf = snap.get("fields", {}) or {}
    lf = live.get("fields", {}) or {}
    if sf and lf:
        for p in sorted(set(sf) | set(lf)):
            x, y = sf.get(p), lf.get(p)
            if x is None:
                findings.append((
                    "SC001", f"{eid}: live field '{p}' ({y}) has no "
                    f"counterpart in the snapshot"))
            elif y is None:
                findings.append((
                    "SC001", f"{eid}: snapshot field '{p}' ({x}) has "
                    f"no counterpart in the live schema"))
            elif x != y:
                findings.append((
                    "SC001", f"{eid}: field '{p}' is {x} in the "
                    f"snapshot but {y} live"))
    ss, ls = snap.get("sub"), live.get("sub")
    if ss is None and ls is None:
        return
    if ss is None or ls is None:
        findings.append((
            "SC001", f"{eid}: nested schema present on only one side "
            f"(snapshot {'has' if ss is not None else 'lacks'} it) — "
            f"device/host or sharded/flat layout changed"))
        return
    if "name" in ss and "name" in ls:       # Keyed engine description
        compare_descriptions(f"{eid}/engine", ss, ls, findings)
        return
    for k in sorted(set(ss) | set(ls)):     # partition sub-element map
        a, b = ss.get(k), ls.get(k)
        if a is None:
            findings.append((
                "SC001", f"{eid}/{k}: live partition element has no "
                f"section in the snapshot"))
        elif b is None:
            findings.append((
                "SC001", f"{eid}/{k}: snapshot carries a partition "
                f"section for an element missing from this runtime"))
        else:
            compare_descriptions(f"{eid}/{k}", a, b, findings)


def verify_compat(snap_descs: Dict[str, dict], live_descs: Dict[str, dict],
                  *, incremental: bool = False,
                  snap_routing: Optional[str] = None,
                  live_routing: Optional[str] = None
                  ) -> List[Tuple[str, str]]:
    """All SC0xx findings blocking a restore of ``snap_descs`` into a
    runtime described by ``live_descs``.  Incremental snapshots only
    carry changed elements, so presence is checked one-way for them."""
    findings: List[Tuple[str, str]] = []
    snap_descs = snap_descs or {}
    live_descs = live_descs or {}
    if snap_routing and live_routing and snap_routing != live_routing:
        findings.append((
            "SC005", f"routing digest drift: snapshot taken under "
            f"FNV-1a routing {snap_routing} but this runtime routes "
            f"with {live_routing} — every per-shard section would land "
            f"on the wrong shard"))
    for eid in sorted(snap_descs):
        if eid not in live_descs:
            findings.append((
                "SC001", f"{eid}: snapshot carries persistent state "
                f"for an element that does not exist in this runtime"))
            continue
        compare_descriptions(eid, snap_descs[eid], live_descs[eid],
                             findings)
    if not incremental:
        for eid in sorted(live_descs):
            if eid not in snap_descs:
                findings.append((
                    "SC001", f"{eid}: live element persists state but "
                    f"the snapshot has no section for it"))
    return findings


# ============================================================== envelope v2

def build_envelope(state: Dict[str, Any], descs: Dict[str, dict],
                   routing: Optional[str], *,
                   incremental: bool = False,
                   prev: Optional[str] = None) -> dict:
    env: Dict[str, Any] = {"v": SCHEMA_ENVELOPE_VERSION,
                           "schema": descs, "routing": routing,
                           "state": state}
    if incremental:
        env["__incremental__"] = True
        env["prev"] = prev
    return env


def parse_envelope(obj) -> Tuple[Dict[str, Any], Optional[dict],
                                 Optional[str], bool, Optional[str]]:
    """(state, schema descs | None, routing, incremental, prev) from a
    loaded snapshot — legacy pre-schema pickles pass through with
    ``descs=None`` (nothing to verify against)."""
    if isinstance(obj, dict) and obj.get("v") == SCHEMA_ENVELOPE_VERSION:
        return (obj.get("state", {}), obj.get("schema") or {},
                obj.get("routing"), bool(obj.get("__incremental__")),
                obj.get("prev"))
    if isinstance(obj, dict) and obj.get("__incremental__"):
        return obj.get("state", {}), None, None, True, None
    return obj if isinstance(obj, dict) else {}, None, None, False, None
