"""QuerySelector: select / group by / having / order by / limit / offset.

(reference: query/selector/QuerySelector.java + GroupByKeyGenerator.java +
attribute/OutputAttributeProcessor — per-event group-key lookup and aggregator
object maps.)

Batched design: the chunk is partitioned by group key once, each aggregator
consumes its group's rows as columns (vectorised running outputs), and the
remaining select expressions run as one fused column program over the whole
batch.  Aggregator calls inside select expressions are intercepted at compile
time via the Scope.function_resolver hook and replaced by reads of synthetic
aggregate-output columns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..plan.expr_compiler import (CompiledExpr, EvalCtx, ExprCompiler, Scope)
from ..query_api.definition import (AbstractDefinition, Attribute, AttrType,
                                    StreamDefinition)
from ..query_api.expression import AttributeFunction, Variable
from ..query_api.query import Selector
from .aggregator import AGGREGATORS, is_aggregator
from .event import CURRENT, EXPIRED, RESET, TIMER, EventChunk
from .processor import Processor
from .stateschema import MapOf, Struct, persistent_schema


class _AggSpec:
    __slots__ = ("name", "arg", "arg_type", "col_name", "output_type",
                 "cls")

    def __init__(self, name: str, arg: Optional[CompiledExpr],
                 col_name: str, cls=None):
        self.name = name
        self.arg = arg
        self.arg_type = arg.type if arg is not None else None
        self.col_name = col_name
        # cls: an extension AttributeAggregator subclass registered via
        # SiddhiManager.set_extension (≙ the reference's custom
        # StringConcatAggregator-style test extensions,
        # query/selector/attribute/aggregator SPI)
        self.cls = cls or AGGREGATORS[name]
        self.output_type = self.cls(self.arg_type).output_type

    def new_instance(self):
        return self.cls(self.arg_type)


@persistent_schema("selector",
                   schema=Struct(aggs=MapOf("agg-slots")))
class QuerySelector(Processor):
    def __init__(self, selector: Selector, input_scope: Scope,
                 input_definition: Optional[AbstractDefinition],
                 compiler_factory, output_id: str = "out"):
        super().__init__()
        self.selector = selector
        self.agg_specs: List[_AggSpec] = []
        self._agg_states: Dict[Tuple, List] = {}
        self._compile(selector, input_scope, input_definition, compiler_factory,
                      output_id)

    # ------------------------------------------------------------ compile

    def _compile(self, selector, input_scope: Scope, input_definition,
                 compiler_factory, output_id):
        # hook aggregator interception into the scope
        prev_resolver = input_scope.function_resolver

        def resolver(f: AttributeFunction):
            if is_aggregator(f.namespace, f.name, len(f.args)):
                return self._register_agg(f, compiler)
            ext = self._find_extension_aggregator(f, compiler)
            if ext is not None:
                return ext
            return prev_resolver(f) if prev_resolver else None

        input_scope.function_resolver = resolver
        compiler: ExprCompiler = compiler_factory(input_scope)

        self.group_by: List[CompiledExpr] = [
            compiler.compile(v) for v in selector.group_by]

        out_attrs: List[Attribute] = []
        self.out_exprs: List[CompiledExpr] = []
        self.out_names: List[str] = []
        if selector.select_all:
            assert input_definition is not None, "select * needs a definition"
            for a in input_definition.attributes:
                ce = compiler.compile(Variable(a.name))
                self.out_exprs.append(ce)
                self.out_names.append(a.name)
                out_attrs.append(Attribute(a.name, ce.type))
        else:
            for oa in selector.attributes:
                ce = compiler.compile(oa.expr)
                if oa.rename in self.out_names:
                    # reference DuplicateAttributeException
                    # (SelectorParser): columnar output would silently
                    # overwrite the earlier column
                    from ..utils.errors import SiddhiAppCreationError
                    raise SiddhiAppCreationError(
                        f"Duplicate output attribute '{oa.rename}' in "
                        "select (use 'as' to alias)")
                self.out_exprs.append(ce)
                self.out_names.append(oa.rename)
                out_attrs.append(Attribute(oa.rename, ce.type))
        self.output_definition = StreamDefinition(output_id, out_attrs)

        # having: output attributes shadow input attributes
        self.having: Optional[CompiledExpr] = None
        if selector.having is not None:
            hs = Scope()
            for a in out_attrs:
                def g(ctx, name=a.name):
                    return ctx.columns[name]
                hs.add(None, a.name, a.type, g)
            # fall back to input scope entries for unshadowed names
            hs._entries = {**input_scope._entries, **hs._entries}
            hs.function_resolver = resolver
            self.having = compiler_factory(hs).compile(selector.having)

        self.order_by = []
        for ob in selector.order_by:
            if ob.variable.attribute in self.out_names:
                self.order_by.append((ob.variable.attribute, ob.ascending))
        self.limit = selector.limit
        self.offset = selector.offset
        input_scope.function_resolver = prev_resolver

    def _register_agg(self, f: AttributeFunction, compiler,
                      cls=None) -> CompiledExpr:
        col = f"__agg_{len(self.agg_specs)}"
        arg = compiler.compile(f.args[0]) if f.args else None
        spec = _AggSpec(f.name.lower(), arg, col, cls=cls)
        self.agg_specs.append(spec)

        def getter(ctx, name=col):
            return ctx.columns[name]
        return CompiledExpr(getter, spec.output_type)

    def _find_extension_aggregator(self, f: AttributeFunction, compiler):
        """Custom attribute aggregators from the extension registry
        (reference: siddhiManager.setExtension + AttributeAggregator SPI,
        query/extension test corpus)."""
        from .aggregator import AttributeAggregator
        reg = getattr(compiler, "extension_registry", None)
        if reg is None:
            return None
        impl = reg.find_function(f.namespace or "", f.name)
        if not (isinstance(impl, type) and
                issubclass(impl, AttributeAggregator)):
            return None
        if len(f.args) != 1:
            from ..utils.errors import SiddhiAppCreationError
            raise SiddhiAppCreationError(
                f"aggregator extension '{f.namespace}:{f.name}' takes "
                f"exactly one argument, got {len(f.args)}")
        return self._register_agg(f, compiler, cls=impl)

    # ------------------------------------------------------------ runtime

    def process(self, chunk: EventChunk):
        n = len(chunk)
        if n == 0:
            return
        data_mask = (chunk.types == CURRENT) | (chunk.types == EXPIRED)
        reset_mask = chunk.types == RESET
        if not data_mask.any() and not reset_mask.any():
            return  # pure TIMER chunk

        ctx = EvalCtx(dict(chunk.columns), chunk.timestamps, n,
                      qualified=chunk.qualified)

        key_cols: Optional[List[np.ndarray]] = None
        if self.agg_specs:
            key_cols = [np.asarray(g.fn(ctx)) for g in self.group_by]
            self._run_aggregators(chunk, ctx, data_mask, reset_mask, key_cols)

        out_cols: Dict[str, np.ndarray] = {}
        for name, ce in zip(self.out_names, self.out_exprs):
            v = ce.fn(ctx)
            if v is None:
                v = np.full(n, None, object)
            if not isinstance(v, np.ndarray) or v.ndim == 0:
                from .event import dtype_for
                arr = np.empty(n, dtype_for(ce.type))
                arr[:] = v
                v = arr
            out_cols[name] = v

        out = EventChunk(self.out_names, chunk.timestamps, chunk.types,
                         out_cols)
        out = out.mask(data_mask)
        keep_idx = np.flatnonzero(data_mask)
        if out.is_empty:
            return

        if self.having is not None:
            hctx = EvalCtx(dict(out.columns), out.timestamps, len(out))
            hm = np.asarray(self.having.fn(hctx), bool)
            if hm.ndim == 0:
                hm = np.full(len(out), bool(hm))
            out = out.mask(hm)
            keep_idx = keep_idx[hm]
            if out.is_empty:
                return

        if self.agg_specs and getattr(chunk, "is_batch", False):
            # batch-marked chunks (lengthBatch/timeBatch/externalTimeBatch/
            # batch windows) summarize: one aggregated row per batch — the
            # last event, or the last per group key in first-seen key order
            # (reference QuerySelector.processInBatchNoGroupBy /
            # processInBatchGroupBy)
            if self.group_by:
                picks: Dict[Tuple, int] = {}
                for pos, oi in enumerate(keep_idx):
                    key = tuple(kc[oi].item() if hasattr(kc[oi], "item")
                                else kc[oi] for kc in key_cols)
                    picks[key] = pos        # dict keeps first-seen key order
                out = out.take(np.asarray(list(picks.values()), np.int64))
            else:
                out = out.take(np.asarray([len(out) - 1], np.int64))

        if self.order_by:
            keys = []
            for name, _asc in reversed(self.order_by):
                col = out.columns[name]
                keys.append(col)
            idx = np.arange(len(out))
            for name, asc in reversed(self.order_by):
                col = out.columns[name]
                order = np.argsort(col[idx], kind="stable")
                if not asc:
                    order = order[::-1]
                idx = idx[order]
            out = out.take(idx)
        if self.offset:
            out = out.slice(self.offset, len(out))
        if self.limit is not None:
            out = out.slice(0, self.limit)
        self.send_next(out)

    def _run_aggregators(self, chunk, ctx, data_mask, reset_mask, key_cols):
        n = len(chunk)
        # group keys (key_cols) were evaluated once in process(); agg args
        # evaluated over the whole batch once here
        arg_vals = [spec.arg.fn(ctx) if spec.arg is not None else None
                    for spec in self.agg_specs]
        from .event import dtype_for
        out_cols = [np.zeros(n, dtype_for(spec.output_type)
                             if spec.output_type not in
                             (AttrType.OBJECT, AttrType.STRING) else object)
                    for spec in self.agg_specs]

        active = data_mask | reset_mask
        idx_active = np.flatnonzero(active)
        if len(idx_active) == 0:
            return
        if self.group_by:
            keys = [tuple(kc[i].item() if hasattr(kc[i], "item") else kc[i]
                          for kc in key_cols) for i in idx_active]
        else:
            keys = [() for _ in idx_active]

        # RESET rows reset every group's state
        if reset_mask.any():
            # process per-row in order, handling resets globally
            for i in idx_active:
                if reset_mask[i]:
                    self._agg_states.clear()
            # fall through to grouped processing (resets already applied
            # before grouped pass only if reset precedes; to keep exact
            # ordering, do a simple ordered pass when resets are present)
            self._ordered_pass(idx_active, keys, arg_vals, chunk.types,
                               out_cols)
        else:
            # group rows by key, vectorised per group
            groups: Dict[Tuple, List[int]] = {}
            for pos, i in enumerate(idx_active):
                groups.setdefault(keys[pos], []).append(i)
            for key, rows in groups.items():
                rows_arr = np.asarray(rows)
                states = self._agg_states.get(key)
                if states is None:
                    states = [spec.new_instance() for spec in self.agg_specs]
                    self._agg_states[key] = states
                tps = chunk.types[rows_arr]
                for si, _spec in enumerate(self.agg_specs):
                    vals = None
                    if arg_vals[si] is not None:
                        v = arg_vals[si]
                        vals = (v[rows_arr] if isinstance(v, np.ndarray)
                                and v.ndim > 0 else
                                np.full(len(rows_arr), v))
                    out_cols[si][rows_arr] = states[si].process(vals, tps)
        for spec, col in zip(self.agg_specs, out_cols):
            ctx.columns[spec.col_name] = col

    def _ordered_pass(self, idx_active, keys, arg_vals, types, out_cols):
        for pos, i in enumerate(idx_active):
            key = keys[pos]
            if types[i] == RESET:
                for states in self._agg_states.values():
                    for si, _spec in enumerate(self.agg_specs):
                        v = arg_vals[si]
                        vals = None if v is None else np.asarray(
                            [v[i] if isinstance(v, np.ndarray) and v.ndim > 0
                             else v])
                        states[si].process(vals, np.asarray([RESET], np.int8))
                continue
            states = self._agg_states.get(key)
            if states is None:
                states = [spec.new_instance() for spec in self.agg_specs]
                self._agg_states[key] = states
            for si, _spec in enumerate(self.agg_specs):
                v = arg_vals[si]
                vals = None if v is None else np.asarray(
                    [v[i] if isinstance(v, np.ndarray) and v.ndim > 0 else v])
                out_cols[si][i] = states[si].process(
                    vals, np.asarray([types[i]], np.int8))[0]

    # ------------------------------------------------------------ state

    def current_state(self):
        return {"aggs": {repr(k): [a.state() for a in v]
                         for k, v in self._agg_states.items()}}

    def restore_state(self, state):
        import ast
        self._agg_states.clear()
        for k, states in state["aggs"].items():
            try:
                key = ast.literal_eval(k)
            except (ValueError, SyntaxError):
                key = k
            insts = [spec.new_instance() for spec in self.agg_specs]
            for inst, s in zip(insts, states):
                inst.restore(s)
            self._agg_states[key] = insts
