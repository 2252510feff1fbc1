"""Source-position threading for query_api nodes.

The tokenizer records (line, col, offset) on every token, but the object
model the parser emits historically dropped them — so anything diagnosed
after parse (semantic analysis, planner rejections) could only say *what*
was wrong, never *where*.  This module threads positions through without
touching dataclass signatures: a node's position lives in a side attribute
(``_pos``) set via :func:`set_pos`, which works uniformly for mutable
dataclasses (Query, StateElement, ...) and frozen ones (the Expression
tree) alike.

Positions are advisory: any node may lack one (fluent-API construction,
``dataclasses.replace`` copies), and consumers must degrade gracefully —
:func:`pos_of` returns ``None`` in that case, and
:func:`nearest_pos` walks an expression tree for the first positioned
node so a diagnostic can anchor to a parent when the exact node is bare.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

_POS_ATTR = "_pos"


@dataclass(frozen=True)
class SourcePos:
    """1-based line/column plus absolute offset into the app source."""
    line: int
    col: int
    offset: int = -1

    def __str__(self) -> str:
        return f"line {self.line}, col {self.col}"


def set_pos(node: Any, pos: "SourcePos | None") -> Any:
    """Attach a source position to any query_api node; returns the node.

    Uses ``object.__setattr__`` so frozen Expression dataclasses accept it
    too.  Silently no-ops for nodes that cannot carry attributes (slots)."""
    if pos is None or node is None:
        return node
    try:
        object.__setattr__(node, _POS_ATTR, pos)
    except (AttributeError, TypeError):
        pass
    return node


def pos_of(node: Any) -> Optional[SourcePos]:
    """The position attached to *node*, or None."""
    return getattr(node, _POS_ATTR, None)


def pos_from_token(tok: Any) -> SourcePos:
    """Build a SourcePos from a compiler token (duck-typed: line/col/pos)."""
    return SourcePos(tok.line, tok.col, getattr(tok, "pos", -1))


def nearest_pos(node: Any) -> Optional[SourcePos]:
    """Position of *node*, else the first positioned descendant (pre-order
    over dataclass fields) — lets diagnostics anchor composite expressions
    whose inner tokens carried the position."""
    seen = set()
    stack = [node]
    while stack:
        n = stack.pop(0)
        if n is None or id(n) in seen:
            continue
        seen.add(id(n))
        p = pos_of(n)
        if p is not None:
            return p
        for f in getattr(n, "__dataclass_fields__", {}):
            v = getattr(n, f, None)
            vs = v if isinstance(v, (list, tuple)) else [v]
            stack.extend(x for x in vs
                         if hasattr(x, "__dataclass_fields__"))
    return None
