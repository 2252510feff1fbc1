"""A pattern condition's capture-reading remainder as a small program for
the CUDA NFA step (K2, the gang K12 and the bank's group instance K3).

The kernels read a condition as its gate bit (the conjuncts that read the
event alone, a torch program evaluated block-wide) AND three compare
tables (``<event> <cmp> <capture>``, ``<capture> <cmp> <constant>``,
``<event> <cmp> <pattern constant>``; ``ops/nfa.NfaKernelProgram``).
Every other conjunct, and the guards the plain condition adds (a nullable
row's validity lane ``> 0``, the ``[last]`` rewrite's ``__cnt_r`` chain
lengths), is lowered here by :func:`lower_program` into one postfix
program a condition, which ``csrc/nfa_step.cuh``'s ``eval_prog`` runs on
a small stack of float32 registers and ``ops/nfa._model_program`` runs
with torch ops:

- operands: an event attribute lane, a capture lane ``(row, lane)`` of
  the slot, a pattern constant (bank), a float32 constant;
- ``+ - * /`` and ``%`` (Java ``%`` is ``fmod``; unary minus is the
  parser's ``0 - x``), ``math:abs``, ``floor``, ``ceil``, ``sqrt`` and
  ``round`` (half to even, as ``torch.round``), ``maximum`` and
  ``minimum`` (a NaN operand gives NaN, as torch's);
- the six compares (``!=`` is true with a NaN operand, every other
  compare false; ``-0.0 == +0.0``), ``and``, ``or``, ``not``.

Types follow the torch program (``plan/expr_compiler.ExprCompiler`` over
``TorchXP``) op by op: every lane is float32, a constant meets a float32
operand rounded to float32 (to nearest), so every value of a program is
float32 and every operation one IEEE operation.  A result the torch
program converts to int32 (INT/LONG arithmetic) stays outside: the card
converts a NaN or out-of-range float32 to int32 otherwise than the CPU.
Sub-trees of constants only are evaluated at build by the torch program
itself.  Anything else raises :class:`Outside` with the reason: the
transcendentals (``log``, ``log10``, ``exp``, ``sin``, ``cos``, ``tan``,
``power``: the card's and the CPU's differ in the last ulp, and a
compare flips on it), strings beyond the code lanes, ``ifThenElse``,
casts, ``is null`` outside the ``[last]`` rewrite, ``in``, and a program
longer, deeper or with more constants than the kernel's limits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..query_api.definition import AttrType
from ..query_api.expression import (And, AttributeFunction, Compare,
                                    CompareOp, Constant, Expression, IsNull,
                                    MathExpr, MathOp, Not, Or, TimeConstant,
                                    Variable)

# opcodes (csrc/nfa_step.cuh ProgOp): low 8 bits the op, the rest its
# argument (an operand's index; OP_CMP: a CMP_OPS index)
OP_EV, OP_CAP, OP_PRM, OP_K = 0, 1, 2, 3
OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD = 4, 5, 6, 7, 8
OP_ABS, OP_FLOOR, OP_CEIL, OP_SQRT, OP_ROUND = 9, 10, 11, 12, 13
OP_MAX, OP_MIN, OP_CMP = 14, 15, 16
OP_AND, OP_OR, OP_NOT = 17, 18, 19
OP_NAMES = ("ev", "cap", "prm", "k", "add", "sub", "mul", "div", "mod",
            "abs", "floor", "ceil", "sqrt", "round", "max", "min", "cmp",
            "and", "or", "not")

#: the kernel's limits a condition (csrc/nfa_step.cuh kProgDepth)
MAX_WORDS = 64
MAX_DEPTH = 8
MAX_CONSTS = 16

#: compare codes, as ops/nfa.CMP_OPS numbers them
_CMP = {CompareOp.LT: 0, CompareOp.LTE: 1, CompareOp.GT: 2,
        CompareOp.GTE: 3, CompareOp.EQ: 4, CompareOp.NEQ: 5}
_MATH = {MathOp.ADD: OP_ADD, MathOp.SUB: OP_SUB, MathOp.MUL: OP_MUL,
         MathOp.DIV: OP_DIV, MathOp.MOD: OP_MOD}
_UNARY = {"abs": OP_ABS, "floor": OP_FLOOR, "ceil": OP_CEIL,
          "sqrt": OP_SQRT, "round": OP_ROUND}
_NARY = {"maximum": OP_MAX, "max": OP_MAX, "minimum": OP_MIN,
         "min": OP_MIN}
_TRANSCENDENTAL = ("log", "log10", "exp", "sin", "cos", "tan", "power",
                   "pow")
_NUMERIC = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)

#: an instruction before encoding: (op, arg) with arg an event lane's
#: name (OP_EV), (row, lane) (OP_CAP), a pattern constant's name
#: (OP_PRM), a float32 value (OP_K), a compare code (OP_CMP), else 0
Instr = Tuple[int, object]


class Outside(Exception):
    """The condition is outside the kernels' program class (the reason)."""

    @property
    def reason(self) -> str:
        return str(self.args[0])


@dataclass
class _Node:
    kind: str                       # "val" or "bool"
    const: object = None            # folded value, or None


def _scalar(v):
    """A folded value as a numpy scalar (the torch program may give a
    0-d tensor)."""
    if hasattr(v, "detach"):
        if v.numel() != 1:
            raise Outside("a constant sub-tree that is not a scalar")
        v = v.reshape(()).cpu().numpy()[()]
    return v


def lower_program(conjuncts: Sequence[Expression],
                  resolve: Callable[[Variable], Instr],
                  param_of: Callable[[Constant], Optional[str]],
                  fold: Callable[[Expression], object],
                  type_of: Callable[[Expression], AttrType]
                  ) -> Tuple[Instr, ...]:
    """The AND of ``conjuncts`` as one postfix program.  ``resolve(var)``
    gives the variable's operand as the torch program's scope binds it
    (``(OP_EV, name)`` or ``(OP_CAP, (row, lane))``) or raises
    :class:`Outside`; ``param_of(c)`` names a pattern constant's lane (a
    bank's compile), else None; ``fold(e)`` evaluates a sub-tree of
    constants by the torch program; ``type_of(e)`` is the torch program's
    declared type of ``e``.  Raises :class:`Outside` outside the class."""
    low = _Lowering(resolve, param_of, fold, type_of)
    out: List[Instr] = []
    depth = 0
    for i, c in enumerate(conjuncts):
        if low.node(c).kind != "bool":
            raise Outside("a value where a condition is expected")
        d = low.emit(c, out)
        depth = max(depth, d if i == 0 else d + 1)
        if i:
            out.append((OP_AND, 0))
    if depth > MAX_DEPTH:
        raise Outside(f"a condition program deeper than {MAX_DEPTH}")
    if len(out) > MAX_WORDS:
        raise Outside(f"a condition program of more than {MAX_WORDS} "
                      f"instructions")
    if len({v for op, v in out if op == OP_K}) > MAX_CONSTS:
        raise Outside(f"a condition program of more than {MAX_CONSTS} "
                      f"constants")
    return tuple(out)


def encode(prog: Sequence[Instr], attr_ix: Callable[[str], int], C: int,
           param_ix: Callable[[str], int]) -> Tuple[Tuple[int, ...],
                                                     Tuple[float, ...]]:
    """A lowered program as the kernel's words and its float32 constants:
    an event lane by its index in the kernel's attributes, a capture lane
    as ``row * C + lane``, a pattern constant by its parameter index, a
    constant by its index in the returned constants."""
    words: List[int] = []
    consts: List[float] = []
    for op, arg in prog:
        if op == OP_EV:
            x = attr_ix(arg)
        elif op == OP_CAP:
            x = arg[0] * C + arg[1]
        elif op == OP_PRM:
            x = param_ix(arg)
        elif op == OP_K:
            bits = [np.float32(c).view(np.int32) for c in consts]
            want = np.float32(arg).view(np.int32)
            if want not in bits:
                consts.append(float(np.float32(arg)))
                bits.append(want)
            x = bits.index(want)
        else:
            x = int(arg)
        words.append(op | (x << 8))
    return tuple(words), tuple(consts)


def describe(words: Sequence[int]) -> List[str]:
    """The words as readable instructions (``cmp:2`` is ``>``)."""
    return [f"{OP_NAMES[w & 0xff]}:{w >> 8}" for w in words]


class _Lowering:
    def __init__(self, resolve, param_of, fold, type_of):
        self.resolve = resolve
        self.param_of = param_of
        self.fold = fold
        self.type_of = type_of
        self.info: Dict[int, _Node] = {}

    # ------------------------------------------------------------ typing

    def node(self, e: Expression) -> _Node:
        got = self.info.get(id(e))
        if got is None:
            got = self.info[id(e)] = self._type(e)
        return got

    def _folded(self, e: Expression) -> _Node:
        v = _scalar(self.fold(e))
        if isinstance(v, (bool, np.bool_)):
            return _Node("bool", bool(v))
        if isinstance(v, (int, float, np.integer, np.floating)):
            return _Node("val", v)
        raise Outside(f"a constant of type {type(v).__name__}")

    def _numeric(self, e: Expression, what: str) -> None:
        t = self.type_of(e)
        if t not in _NUMERIC:
            raise Outside(f"a {t.name} {what} (strings beyond the code "
                          f"lanes)" if t == AttrType.STRING else
                          f"a {t.name} {what}")

    def _type(self, e: Expression) -> _Node:
        if isinstance(e, TimeConstant):
            raise Outside("a time constant in a condition")
        if isinstance(e, Constant):
            if self.param_of(e) is not None:
                return _Node("val")
            if isinstance(e.value, (bool, np.bool_)):
                return _Node("bool", bool(e.value))
            if not isinstance(e.value, (int, float)):
                raise Outside(f"the constant {e.value!r} (strings beyond "
                              f"the code lanes)")
            return self._folded(e)
        if isinstance(e, Variable):
            self.resolve(e)
            self._numeric(e, "attribute")
            return _Node("val")
        if isinstance(e, MathExpr):
            l, r = self.node(e.left), self.node(e.right)
            if l.kind != "val" or r.kind != "val":
                raise Outside("arithmetic on a condition")
            if l.const is not None and r.const is not None:
                return self._folded(e)
            t = self.type_of(e)
            if t in (AttrType.INT, AttrType.LONG):
                raise Outside(
                    "INT/LONG arithmetic (its float32 to int32 conversion "
                    "of a NaN or out-of-range value differs between the "
                    "card and the CPU)")
            if t not in _NUMERIC:
                raise Outside(f"{t.name} arithmetic")
            return _Node("val")
        if isinstance(e, AttributeFunction):
            ns = (e.namespace or "").lower()
            low = e.name.lower()
            qual = f"{ns}:{e.name}" if ns else e.name
            if ns == "math" and low in _TRANSCENDENTAL:
                raise Outside(f"the transcendental {qual} (the card's and "
                              f"the CPU's differ in the last ulp)")
            ok = (ns == "math" and low in _UNARY and len(e.args) == 1) or \
                (ns == "" and low in _NARY and len(e.args) > 1)
            if not ok:
                raise Outside(f"the function {qual}")
            kids = [self.node(a) for a in e.args]
            if any(k.kind != "val" for k in kids):
                raise Outside(f"a condition as an argument of {qual}")
            if all(k.const is not None for k in kids):
                return self._folded(e)
            self._numeric(e, f"result of {qual}")
            return _Node("val")
        if isinstance(e, Compare):
            l, r = self.node(e.left), self.node(e.right)
            if l.kind != "val" or r.kind != "val":
                raise Outside("a compare of conditions")
            if l.const is not None and r.const is not None:
                return self._folded(e)
            for x in (e.left, e.right):
                self._numeric(x, "compare operand")
            return _Node("bool")
        if isinstance(e, (And, Or)):
            l, r = self.node(e.left), self.node(e.right)
            if l.kind != "bool" or r.kind != "bool":
                raise Outside(f"a value under "
                              f"'{type(e).__name__.lower()}'")
            if l.const is not None and r.const is not None:
                v = (l.const and r.const) if isinstance(e, And) \
                    else (l.const or r.const)
                return _Node("bool", v)
            return _Node("bool")
        if isinstance(e, Not):
            x = self.node(e.expr)
            if x.kind != "bool":
                raise Outside("a value under 'not'")
            return _Node("bool", None if x.const is None else not x.const)
        if isinstance(e, IsNull):
            raise Outside("`is null` outside the [last] rewrite")
        raise Outside(f"{type(e).__name__} in a condition")

    # --------------------------------------------------------- emission

    def emit(self, e: Expression, out: List[Instr]) -> int:
        """Postfix code of ``e`` into ``out``; its stack depth."""
        n = self.node(e)
        if n.const is not None:
            v = n.const
            if isinstance(v, bool):
                v = 1.0 if v else 0.0
            out.append((OP_K, float(np.float32(v))))
            return 1
        if isinstance(e, Constant):
            out.append((OP_PRM, self.param_of(e)))
            return 1
        if isinstance(e, Variable):
            out.append(self.resolve(e))
            return 1
        if isinstance(e, (MathExpr, Compare, And, Or)):
            a = self.emit(e.left, out)
            b = self.emit(e.right, out)
            if isinstance(e, MathExpr):
                out.append((_MATH[e.op], 0))
            elif isinstance(e, Compare):
                out.append((OP_CMP, _CMP[e.op]))
            else:
                out.append((OP_AND if isinstance(e, And) else OP_OR, 0))
            return max(a, b + 1)
        if isinstance(e, Not):
            d = self.emit(e.expr, out)
            out.append((OP_NOT, 0))
            return d
        low = e.name.lower()
        if low in _UNARY:
            d = self.emit(e.args[0], out)
            out.append((_UNARY[low], 0))
            return d
        d = self.emit(e.args[0], out)
        for a in e.args[1:]:
            d = max(d, self.emit(a, out) + 1)
            out.append((_NARY[low], 0))
        return d
