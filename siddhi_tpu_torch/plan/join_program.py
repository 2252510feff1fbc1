"""The join on-condition as a small program for the fused probe (K11).

The device probe's condition runs over the cross product of an arriving
chunk (rows, the left side) and the opposite buffer (columns, the right
side).  As a torch program it writes a ``[nl2, nr2]`` bool mask that the
compaction then reads: at a join's usual sizes the mask is the whole
cost.  :func:`lower_condition` compiles the condition, after
``plan/join_lanes.JoinLanes.rewrite`` (string codes and double key pairs
are already i32 lanes), into a :class:`ProbeProgram` that
``ops/join_probe.probe_fused`` evaluates cell by cell, with no mask:

- **side programs**: each maximal sub-tree that reads one side only (a
  lane, arithmetic on a side's lanes and constants, a one-sided compare or
  boolean) is a *slot* of that side, computed once a row (left) or once a
  column (right) by a postfix program over the side's lanes;
- **atoms**: each compare that reads both sides, and each one-sided
  boolean slot, is an atom ``x <op> y``.  An operand is a left slot, a
  right slot or a constant;
- **tree**: the and/or/not tree over the atoms, as a postfix program
  (atom ``a``, true, false, and, or, not) that the kernel runs on 32-row
  masks of atom values, one bitwise operation a node.

The class: the six compares on f32 and on i32; ``and``, ``or``, ``not``;
f32 ``+ - * /`` on one side's lanes and constants (unary minus is the
parser's ``0 - x``); lanes and numeric constants.  Arithmetic that reads
both sides is outside it: interpreted per cell it was about 1.8x slower
than the mask route at the join cell's shape on an H100.  Types follow
the torch program's (``plan/expr_compiler.TorchXP``) exactly: attribute
lanes are f32, ``__``-named lanes (string codes, double key halves) i32;
a compare runs on i32 when both operands are i32 (lanes or integer
constants), else on f32, an i32 operand converted (round to nearest) as
torch promotes it; a constant is rounded to f32 where it meets f32.  Sub-trees of constants
only are evaluated at build by the torch program itself.  Compares:
``!=`` is true with a NaN operand, every other compare false; ``-0.0 ==
+0.0``.  Anything else (functions, ``%``, casts, ``in``, ``is null``, a
bool attribute, more atoms, slots, constants or code than the kernel's
parameter block holds) raises :class:`Unfused` with the reason, and the
join keeps the mask route (the torch program and ``probe_compact``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..query_api.expression import (And, Compare, CompareOp, Constant,
                                    Expression, MathExpr, MathOp, Not, Or,
                                    TimeConstant, Variable)

# opcodes (csrc/join_probe.cu Op): low 8 bits the op, the rest its argument
OP_LANE, OP_CONST = 0, 1
OP_ADD, OP_SUB, OP_MUL, OP_DIV = 2, 3, 4, 5
OP_I2F, OP_CMPF, OP_CMPI = 6, 7, 8
OP_AND, OP_OR, OP_NOT, OP_STORE = 9, 10, 11, 12

# compare codes (csrc/join_probe.cu Cmp)
CMP_LT, CMP_LE, CMP_GT, CMP_GE, CMP_EQ, CMP_NE = range(6)
_CMP = {CompareOp.LT: CMP_LT, CompareOp.LTE: CMP_LE, CompareOp.GT: CMP_GT,
        CompareOp.GTE: CMP_GE, CompareOp.EQ: CMP_EQ, CompareOp.NEQ: CMP_NE}
#: x <op> y == y <REFLECT[op]> x
REFLECT = {CMP_LT: CMP_GT, CMP_LE: CMP_GE, CMP_GT: CMP_LT, CMP_GE: CMP_LE,
           CMP_EQ: CMP_EQ, CMP_NE: CMP_NE}

# atom operand kinds
K_LSLOT, K_RSLOT, K_CONST = 0, 1, 2

# tree opcodes (csrc/join_probe.cu Tree): low 8 bits the op, then the atom
T_ATOM, T_TRUE, T_FALSE, T_AND, T_OR, T_NOT = range(6)

# the kernel's parameter block (csrc/join_probe.cu)
MAX_ATOMS = 8
MAX_SLOTS = 8            # a side
MAX_LANES = 16           # a side
MAX_CONSTS = 16
MAX_CODE = 128
MAX_TREE = 64
MAX_STACK = 8

_MATH = {MathOp.ADD: OP_ADD, MathOp.SUB: OP_SUB, MathOp.MUL: OP_MUL,
         MathOp.DIV: OP_DIV}


class Unfused(Exception):
    """The condition is outside the fused probe's class (the reason)."""


@dataclass
class ProbeProgram:
    """A lowered condition.  ``code`` holds the left program, then the
    right program."""
    lanes: Tuple[List[str], List[str]]   # lanes each side's code reads
    code: np.ndarray                     # int32 words
    left_len: int
    right_len: int
    n_slots: Tuple[int, int]
    consts: np.ndarray                   # uint32 bit patterns
    atoms: np.ndarray                    # int32 [A, 6]: op, i32, xk, xa, yk, ya
    tree: np.ndarray                     # int32 postfix over the atoms
    stack: int                           # deepest stack a program reaches

    @property
    def n_atoms(self) -> int:
        return int(self.atoms.shape[0])


@dataclass
class _Node:
    kind: str                  # "val" or "bool"
    dtype: Optional[str]       # "f" (f32) or "i" (i32) for values
    sides: frozenset           # sides read: {0} left, {1} right
    const: object = None       # folded value (numpy scalar / bool), or None


def _ins(op: int, arg: int = 0) -> int:
    return op | (arg << 8)


def lower_condition(cond: Expression,
                    resolve: Callable[[Variable], Tuple[int, str]],
                    fold: Callable[[Expression], object]) -> ProbeProgram:
    """``cond`` (rewritten by JoinLanes) as a :class:`ProbeProgram`.
    ``resolve(var)`` gives the variable's side (0 left, 1 right) and lane
    name, as the torch program's scope binds it, or raises
    :class:`Unfused`; ``fold(expr)`` evaluates a sub-tree of constants by
    the torch program.  Raises :class:`Unfused` outside the class."""
    return _Lowering(resolve, fold).run(cond)


class _Lowering:
    def __init__(self, resolve, fold):
        self.resolve = resolve
        self.fold = fold
        self.info: Dict[int, _Node] = {}
        self.lanes: Tuple[List[str], List[str]] = ([], [])
        self.side_code: Tuple[List[int], List[int]] = ([], [])
        self.slots: Tuple[Dict[str, int], Dict[str, int]] = ({}, {})
        self.consts: List[int] = []
        self.atoms: List[List[int]] = []
        self.stack = 0

    # ------------------------------------------------------------ typing

    def node(self, e: Expression) -> _Node:
        got = self.info.get(id(e))
        if got is None:
            got = self.info[id(e)] = self._type(e)
        return got

    def _folded(self, e) -> _Node:
        v = self.fold(e)
        try:
            import torch
            if isinstance(v, torch.Tensor):
                if v.numel() != 1:
                    raise Unfused(f"constant {e!r} is not a scalar")
                v = v.reshape(()).cpu().numpy()[()]
        except ImportError:       # pragma: no cover - the port needs torch
            pass
        if isinstance(v, (bool, np.bool_)):
            return _Node("bool", None, frozenset(), bool(v))
        if isinstance(v, (int, np.integer)):
            return _Node("val", "i", frozenset(), v)
        if isinstance(v, (float, np.floating)):
            return _Node("val", "f", frozenset(), v)
        raise Unfused(f"constant {e!r} of type {type(v).__name__}")

    def _type(self, e: Expression) -> _Node:
        if isinstance(e, TimeConstant):
            raise Unfused("a time constant")
        if isinstance(e, Constant):
            if isinstance(e.value, str) or e.value is None:
                raise Unfused(f"constant {e.value!r}")
            return self._folded(e)
        if isinstance(e, Variable):
            side, name = self.resolve(e)
            return _Node("val", "i" if name.startswith("__") else "f",
                         frozenset((side,)))
        if isinstance(e, MathExpr):
            if e.op not in _MATH:
                raise Unfused(f"the math operator '{e.op.value}'")
            l, r = self.node(e.left), self.node(e.right)
            if l.kind != "val" or r.kind != "val":
                raise Unfused("arithmetic on a condition")
            if l.const is not None and r.const is not None:
                return self._folded(e)
            if "i" in (x.dtype for x in (l, r) if x.const is None):
                raise Unfused("arithmetic on an i32 lane")
            if len(l.sides | r.sides) == 2:
                raise Unfused("arithmetic that reads both sides")
            return _Node("val", "f", l.sides | r.sides)
        if isinstance(e, Compare):
            l, r = self.node(e.left), self.node(e.right)
            if l.kind != "val" or r.kind != "val":
                raise Unfused("a compare of conditions")
            if l.const is not None and r.const is not None:
                return self._folded(e)
            return _Node("bool", None, l.sides | r.sides)
        if isinstance(e, (And, Or)):
            l, r = self.node(e.left), self.node(e.right)
            if l.kind != "bool" or r.kind != "bool":
                raise Unfused(f"a value under '{type(e).__name__.lower()}'")
            if l.const is not None and r.const is not None:
                v = (l.const and r.const) if isinstance(e, And) \
                    else (l.const or r.const)
                return _Node("bool", None, frozenset(), v)
            return _Node("bool", None, l.sides | r.sides)
        if isinstance(e, Not):
            x = self.node(e.expr)
            if x.kind != "bool":
                raise Unfused("a value under 'not'")
            if x.const is not None:
                return _Node("bool", None, frozenset(), not x.const)
            return _Node("bool", None, x.sides)
        raise Unfused(f"{type(e).__name__} is outside the fused probe's "
                      f"class")

    # --------------------------------------------------------- emission

    @staticmethod
    def _domain(l: _Node, r: _Node) -> str:
        return "i" if l.dtype == "i" and r.dtype == "i" else "f"

    def _const(self, n: _Node, dom: str) -> int:
        v = n.const
        if dom == "f":
            if isinstance(v, (int, np.integer)) and abs(int(v)) > 1 << 53:
                raise Unfused(f"integer constant {int(v)} past 2^53")
            bits = int(np.asarray(np.float32(v)).view(np.uint32))
        else:
            if not -(1 << 31) <= int(v) < 1 << 31:
                raise Unfused(f"integer constant {int(v)} outside int32 "
                              f"beside an i32 lane")
            bits = int(np.uint32(np.int64(v) & 0xffffffff))
        if bits not in self.consts:
            if len(self.consts) == MAX_CONSTS:
                raise Unfused(f"more than {MAX_CONSTS} constants")
            self.consts.append(bits)
        return self.consts.index(bits)

    def _lane(self, side: int, name: str) -> int:
        lanes = self.lanes[side]
        if name not in lanes:
            if len(lanes) == MAX_LANES:
                raise Unfused(f"more than {MAX_LANES} lanes a side")
            lanes.append(name)
        return lanes.index(name)

    def _postfix(self, e: Expression, dom: str, out: List[int]) -> int:
        """Postfix code of the one-sided ``e`` into ``out`` (values in
        domain ``dom``).  Returns the stack depth."""
        n = self.node(e)
        if n.const is not None:
            if n.kind == "bool":
                raise Unfused("a constant condition inside a side program")
            out.append(_ins(OP_CONST, self._const(n, dom)))
            return 1
        if isinstance(e, Variable):
            out.append(_ins(OP_LANE, self._lane(*self.resolve(e))))
            return 1
        if isinstance(e, MathExpr):
            a = self._postfix(e.left, "f", out)
            b = self._postfix(e.right, "f", out)
            out.append(_ins(_MATH[e.op]))
            return max(a, b + 1)
        if isinstance(e, Compare):
            d = self._domain(self.node(e.left), self.node(e.right))
            a = self._postfix(e.left, d, out)
            b = self._postfix(e.right, d, out)
            out.append(_ins(OP_CMPI if d == "i" else OP_CMPF, _CMP[e.op]))
            return max(a, b + 1)
        if isinstance(e, (And, Or)):
            a = self._postfix(e.left, dom, out)
            b = self._postfix(e.right, dom, out)
            out.append(_ins(OP_AND if isinstance(e, And) else OP_OR))
            return max(a, b + 1)
        if isinstance(e, Not):
            a = self._postfix(e.expr, dom, out)
            out.append(_ins(OP_NOT))
            return a
        raise Unfused(f"{type(e).__name__} in a program")  # pragma: no cover

    def _depth(self, d: int) -> None:
        if d > MAX_STACK:
            raise Unfused(f"a program deeper than {MAX_STACK}")
        self.stack = max(self.stack, d)

    def _slot(self, e: Expression, dom: str) -> Tuple[int, int]:
        """A one-sided sub-tree as a slot of its side: (side, slot)."""
        n = self.node(e)
        side = next(iter(n.sides))
        cvt = n.kind == "val" and n.dtype == "i" and dom == "f"
        key = repr(e) + (":f" if cvt else "")
        slots = self.slots[side]
        if key not in slots:
            if len(slots) == MAX_SLOTS:
                raise Unfused(f"more than {MAX_SLOTS} one-sided sub-trees "
                              f"a side")
            code = self.side_code[side]
            dtype = n.dtype if n.kind == "val" else "i"
            self._depth(self._postfix(e, dtype, code))
            if cvt:
                code.append(_ins(OP_I2F))
            slots[key] = len(slots)
            code.append(_ins(OP_STORE, slots[key]))
        return side, slots[key]

    def _operand(self, e: Expression, dom: str) -> Tuple[int, int]:
        """An atom's operand: (kind, argument)."""
        n = self.node(e)
        if n.const is not None:
            return K_CONST, self._const(n, dom)
        side, s = self._slot(e, dom)   # a value reads one side (_type)
        return (K_LSLOT if side == 0 else K_RSLOT), s

    def _atom(self, op: int, dom: str, x, y) -> int:
        if y[0] == K_LSLOT and x[0] != K_LSLOT:
            x, y, op = y, x, REFLECT[op]
        if len(self.atoms) == MAX_ATOMS:
            raise Unfused(f"more than {MAX_ATOMS} cross-side compares")
        self.atoms.append([op, int(dom == "i"), x[0], x[1], y[0], y[1]])
        return len(self.atoms) - 1

    def _tree(self, e: Expression):
        """The boolean tree over atoms: a bool, an atom index, or
        (op, children)."""
        n = self.node(e)
        if n.const is not None:
            return bool(n.const)
        if len(n.sides) == 1:
            x = self._operand(e, "i")
            zero = self._const(_Node("val", "i", frozenset(), 0), "i")
            return self._atom(CMP_NE, "i", x, (K_CONST, zero))
        if isinstance(e, Compare):
            dom = self._domain(self.node(e.left), self.node(e.right))
            return self._atom(_CMP[e.op], dom, self._operand(e.left, dom),
                              self._operand(e.right, dom))
        if isinstance(e, Not):
            return ("not", [self._tree(e.expr)])
        return ("and" if isinstance(e, And) else "or",
                [self._tree(e.left), self._tree(e.right)])

    def run(self, cond: Expression) -> ProbeProgram:
        top = self.node(cond)
        if top.kind != "bool":
            raise Unfused("the condition is a value, not a compare")
        tree = self._tree(cond)
        A = len(self.atoms)
        code_t: List[int] = []

        def emit(t) -> int:
            """Postfix of the tree into code_t; its stack depth."""
            if isinstance(t, bool):
                code_t.append(T_TRUE if t else T_FALSE)
                return 1
            if isinstance(t, int):
                code_t.append(_ins(T_ATOM, t))
                return 1
            op, kids = t
            if op == "not":
                d = emit(kids[0])
                code_t.append(T_NOT)
                return d
            a, b = emit(kids[0]), emit(kids[1])
            code_t.append(T_AND if op == "and" else T_OR)
            return max(a, b + 1)
        self._depth(emit(tree))
        if len(code_t) > MAX_TREE:
            raise Unfused(f"an and/or/not tree of more than {MAX_TREE} "
                          f"nodes")
        left, right = self.side_code
        code = list(left) + list(right)
        if len(code) > MAX_CODE:
            raise Unfused(f"more than {MAX_CODE} instructions")
        return ProbeProgram(
            lanes=(list(self.lanes[0]), list(self.lanes[1])),
            code=np.asarray(code, np.int32), left_len=len(left),
            right_len=len(right),
            n_slots=(len(self.slots[0]), len(self.slots[1])),
            consts=np.asarray(self.consts, np.uint32),
            atoms=np.asarray(self.atoms, np.int32).reshape(A, 6),
            tree=np.asarray(code_t, np.int32), stack=self.stack)
