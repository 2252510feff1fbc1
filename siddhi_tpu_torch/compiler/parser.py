"""SiddhiQL recursive-descent parser → query_api object model.

Counterpart of the reference's ANTLR4 parse tree + SiddhiQLBaseVisitorImpl
(modules/siddhi-query-compiler/.../internal/SiddhiQLBaseVisitorImpl.java, 3,073
LoC): app structure, definitions, queries, joins, patterns/sequences,
partitions, store queries, expressions with full precedence, time constants,
annotations.  Grammar shape follows SiddhiQL.g4 (918 lines) but is hand-rolled:
the object model it emits feeds a *compiler* (plan/), not an interpreter.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..query_api import (AbsentStreamStateElement, AggregationDefinition,
                         Annotation, AttrType, CompareOp, Constant,
                         CountStateElement, DeleteStream, Element, EventTrigger,
                         EveryStateElement, Expression, Filter,
                         FunctionDefinition, InputStore, InsertIntoStream,
                         JoinInputStream, JoinType, LogicalOp,
                         LogicalStateElement, MathOp, NextStateElement,
                         OrderByAttribute, OutputAttribute, OutputEventsFor,
                         OutputRate, OutputRateType, Partition,
                         Query, RangePartitionProperty, RangePartitionType,
                         ReturnStream, Selector, SiddhiApp, SingleInputStream,
                         StateInputStream, StateType, StoreQuery,
                         StoreQueryType, StreamDefinition, StreamFunctionHandler,
                         StreamStateElement, TableDefinition, TimeConstant,
                         TriggerDefinition, UpdateOrInsertStream,
                         UpdateSetAssignment, UpdateStream, ValuePartitionType,
                         Variable, WindowDefinition, WindowHandler)
from ..query_api.expression import (LAST_INDEX, And, AttributeFunction, Compare,
                                    In, IsNull, MathExpr, Not, Or)
from ..query_api.position import pos_from_token, set_pos
from ..utils.errors import SiddhiParserException
from .tokenizer import Token, tokenize

_TIME_UNITS_MS = {
    "millisecond": 1, "milliseconds": 1, "ms": 1, "millisec": 1,
    "second": 1000, "seconds": 1000, "sec": 1000,
    "minute": 60_000, "minutes": 60_000, "min": 60_000,
    "hour": 3_600_000, "hours": 3_600_000,
    "day": 86_400_000, "days": 86_400_000,
    "week": 604_800_000, "weeks": 604_800_000,
    "month": 2_592_000_000, "months": 2_592_000_000,
    "year": 31_536_000_000, "years": 31_536_000_000,
}

_JOIN_START = ("join", "inner", "left", "right", "full", "unidirectional")


class Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.pos = 0

    # ------------------------------------------------- token helpers
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "EOF":
            self.pos += 1
        return t

    def at_kw(self, *kws: str, k: int = 0) -> bool:
        return self.peek(k).is_kw(*kws)

    def at_op(self, *ops: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == "OP" and t.text in ops

    def eat_kw(self, *kws: str) -> Token:
        if not self.at_kw(*kws):
            t = self.peek()
            raise SiddhiParserException(
                f"Expected {'/'.join(kws)} but found {t.text!r}", t.line, t.col)
        return self.next()

    def eat_op(self, op: str) -> Token:
        if not self.at_op(op):
            t = self.peek()
            raise SiddhiParserException(
                f"Expected {op!r} but found {t.text!r}", t.line, t.col)
        return self.next()

    def eat_id(self) -> Token:
        t = self.peek()
        if t.kind != "ID":
            raise SiddhiParserException(
                f"Expected identifier but found {t.text!r}", t.line, t.col)
        return self.next()

    def try_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def try_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def mark(self):
        """Source position of the NEXT token — attach with set_pos()."""
        return pos_from_token(self.peek())

    # ------------------------------------------------- app

    def parse_app(self) -> SiddhiApp:
        app = SiddhiApp()
        while self.peek().kind != "EOF":
            anns = self.parse_annotations()
            # `@app:...` annotations belong to the app itself (reference
            # grammar: app_annotation rule)
            app_anns = [a for a in anns if a.name.lower().startswith("app")]
            anns = [a for a in anns if not a.name.lower().startswith("app")]
            app.annotations.extend(app_anns)
            if self.peek().kind == "EOF":
                break
            if self.at_kw("define"):
                self.parse_definition(app, anns)
            elif self.at_kw("partition"):
                app.add_partition(self.parse_partition(anns))
            elif self.at_kw("from", "select"):
                app.add_query(self.parse_query(anns))
            else:
                t = self.peek()
                raise SiddhiParserException(
                    f"Unexpected token {t.text!r} at app level", t.line, t.col)
            while self.try_op(";"):
                pass
        return app

    # ------------------------------------------------- annotations

    def parse_annotations(self) -> List[Annotation]:
        anns = []
        while self.at_op("@"):
            anns.append(self.parse_annotation())
        return anns

    def parse_annotation(self) -> Annotation:
        self.eat_op("@")
        name = self.eat_id().text
        if self.try_op(":"):
            name = name + ":" + self.eat_id().text
        ann = Annotation(name)
        if self.try_op("("):
            while not self.at_op(")"):
                if self.at_op("@"):
                    ann.annotations.append(self.parse_annotation())
                else:
                    # key='value' | key=123 | 'positional' | key.with.dots='v'
                    if self.peek().kind == "ID":
                        key_parts = [self.eat_id().text]
                        while self.try_op("."):
                            key_parts.append(self.eat_id().text)
                        key = ".".join(key_parts)
                        self.eat_op("=")
                        ann.elements.append(Element(key, self._ann_value()))
                    else:
                        ann.elements.append(Element(None, self._ann_value()))
                if not self.try_op(","):
                    break
            self.eat_op(")")
        return ann

    def _ann_value(self) -> str:
        t = self.peek()
        if t.kind == "OP" and t.text == "-":
            # signed numeric value, e.g. @attr:range('delta', -500, 500)
            self.next()
            t = self.peek()
            if t.kind in ("INT", "LONG", "FLOAT", "DOUBLE"):
                self.next()
                return "-" + t.text
            raise SiddhiParserException(
                f"Expected a number after '-' in annotation value, "
                f"found {t.text!r}", t.line, t.col)
        if t.kind in ("STRING", "INT", "LONG", "FLOAT", "DOUBLE"):
            self.next()
            return t.text if t.kind != "STRING" else t.value
        if t.kind == "ID":
            self.next()
            return t.text
        raise SiddhiParserException(
            f"Invalid annotation value {t.text!r}", t.line, t.col)

    # ------------------------------------------------- definitions

    def parse_definition(self, app: SiddhiApp, anns: List[Annotation]):
        def_pos = self.mark()
        self.eat_kw("define")
        kind = self.eat_id().text.lower()
        if kind == "stream":
            d = StreamDefinition(self.eat_id().text, annotations=anns)
            set_pos(d, def_pos)
            self._parse_attr_list(d)
            app.define_stream(d)
        elif kind == "table":
            d = TableDefinition(self.eat_id().text, annotations=anns)
            set_pos(d, def_pos)
            self._parse_attr_list(d)
            app.define_table(d)
        elif kind == "window":
            d = WindowDefinition(self.eat_id().text, annotations=anns)
            set_pos(d, def_pos)
            self._parse_attr_list(d)
            ns, name, params = self._parse_window_call()
            d.window_namespace, d.window_name, d.window_params = ns, name, params
            if self.try_kw("output"):
                d.output_event_type = self._parse_event_type_kw()
            app.define_window(d)
        elif kind == "trigger":
            tid = self.eat_id().text
            self.eat_kw("at")
            td = TriggerDefinition(tid, annotations=anns)
            if self.peek().kind == "STRING":
                s = self.next().value
                if s == "start":
                    td.at_start = True
                else:
                    td.at_cron = s
            else:
                self.eat_kw("every")
                td.at_every_ms = self._parse_time_value()
            app.define_trigger(td)
        elif kind == "function":
            fid = self.eat_id().text
            self.eat_op("[")
            lang = self.eat_id().text
            self.eat_op("]")
            self.eat_kw("return")
            rt = AttrType.of(self.eat_id().text)
            body = self._parse_script_body()
            app.define_function(FunctionDefinition(fid, lang.lower(), rt, body))
        elif kind == "aggregation":
            app.define_aggregation(self._parse_aggregation_def(anns))
        else:
            t = self.peek()
            raise SiddhiParserException(f"Unknown definition kind {kind!r}",
                                        t.line, t.col)

    def _parse_attr_list(self, d):
        self.eat_op("(")
        while not self.at_op(")"):
            attr_pos = self.mark()
            name = self.eat_id().text
            d.attribute(name, AttrType.of(self.eat_id().text))
            set_pos(d.attributes[-1], attr_pos)
            if not self.try_op(","):
                break
        self.eat_op(")")

    def _parse_window_call(self) -> Tuple[Optional[str], str, List[Expression]]:
        ns = None
        name = self.eat_id().text
        if self.try_op(":"):
            ns, name = name, self.eat_id().text
        params: List[Expression] = []
        if self.try_op("("):
            while not self.at_op(")"):
                params.append(self.parse_expression())
                if not self.try_op(","):
                    break
            self.eat_op(")")
        return ns, name, params

    def _parse_event_type_kw(self) -> str:
        tok = self.peek()
        t = self.eat_id().text.lower()
        if t not in ("current", "expired", "all"):
            raise SiddhiParserException(f"Bad event type {t!r}",
                                        tok.line, tok.col)
        self.try_kw("events")
        return t

    def _parse_script_body(self) -> str:
        # body is a { ... } block captured as RAW text (scripts are
        # whitespace-sensitive, e.g. python)
        t = self.peek()
        if not self.at_op("{"):
            raise SiddhiParserException("Expected '{' for function body",
                                        t.line, t.col)
        start = t.pos + 1
        depth = 0
        i = t.pos
        text = self.text
        in_str: Optional[str] = None
        while i < len(text):
            c = text[i]
            if in_str is not None:
                if c == in_str:
                    in_str = None
            elif c in "'\"":
                in_str = c
            elif c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        if depth != 0:
            raise SiddhiParserException("Unterminated function body",
                                        t.line, t.col)
        body = text[start:i]
        # skip all tokens inside the braces
        while self.peek().kind != "EOF" and self.peek().pos <= i:
            self.next()
        return body

    def _parse_aggregation_def(self, anns) -> AggregationDefinition:
        aid = self.eat_id().text
        self.eat_kw("from")
        stream = self.parse_single_stream()
        self.eat_kw("select")
        selector = self.parse_selector_body()
        self._parse_selector_suffix(selector)
        self.eat_kw("aggregate")
        by_attr = None
        if self.try_kw("by"):
            by_attr = self.eat_id().text
        self.eat_kw("every")
        t = self.eat_id()
        periods = [self._norm_duration(t.text, t)]
        if self.at_op("."):  # range: sec ... year
            self.eat_op(".")
            self.eat_op(".")
            self.eat_op(".")
            t = self.eat_id()
            periods.append(self._norm_duration(t.text, t))
            from ..query_api.definition import DURATION_ORDER
            lo = DURATION_ORDER.index(periods[0])
            hi = DURATION_ORDER.index(periods[1])
            periods = DURATION_ORDER[lo:hi + 1]
        else:
            while self.try_op(","):
                t = self.eat_id()
                periods.append(self._norm_duration(t.text, t))
        return AggregationDefinition(aid, stream, selector, by_attr, periods, anns)

    @staticmethod
    def _norm_duration(word: str, tok: Optional[Token] = None) -> str:
        w = word.lower().rstrip("s") if word.lower() != "s" else word.lower()
        m = {"second": "sec", "sec": "sec", "minute": "min", "min": "min",
             "hour": "hour", "day": "day", "month": "month", "year": "year"}
        if w not in m:
            raise SiddhiParserException(
                f"Bad aggregation duration {word!r}",
                tok.line if tok else -1, tok.col if tok else -1)
        return m[w]

    # ------------------------------------------------- query

    def parse_query(self, anns: List[Annotation]) -> Query:
        q = Query(annotations=anns)
        set_pos(q, self.mark())
        self.eat_kw("from")
        q.input_stream = self.parse_input_stream()
        if self.try_kw("select"):
            q.selector = self.parse_selector_body()
        else:
            q.selector = Selector(select_all=True)
        self._parse_selector_suffix(q.selector)
        if self.try_kw("output"):
            q.output_rate = self.parse_output_rate()
        out_pos = self.mark()
        q.output_stream = set_pos(self.parse_output_action(), out_pos)
        return q

    def parse_output_rate(self) -> OutputRate:
        r = OutputRate()
        t = self.peek()
        if self.try_kw("snapshot"):
            r.type = OutputRateType.SNAPSHOT
            self.eat_kw("every")
            r.every_ms = self._parse_time_value()
            return r
        if self.try_kw("first"):
            r.type = OutputRateType.FIRST
        elif self.try_kw("last"):
            r.type = OutputRateType.LAST
        elif self.try_kw("all"):
            r.type = OutputRateType.ALL
        self.eat_kw("every")
        if self.peek().kind in ("INT", "LONG") and self.peek(1).is_kw("events"):
            r.every_events = int(self.next().value)
            self.eat_kw("events")
        else:
            r.every_ms = self._parse_time_value()
        return r

    def parse_output_action(self):
        if self.try_kw("insert"):
            if self.try_kw("overwrite"):   # legacy alias of update or insert
                self.eat_kw("into")
                target = self.eat_id().text
                on = None
                if self.try_kw("on"):
                    on = self.parse_expression()
                return UpdateOrInsertStream(target, OutputEventsFor.CURRENT, on=on)
            ef = OutputEventsFor.CURRENT
            if self.at_kw("current", "expired", "all"):
                ef = OutputEventsFor(self._parse_event_type_kw())
            self.eat_kw("into")
            is_inner = self.try_op("#")
            is_fault = (not is_inner) and self.try_op("!")
            target = self.eat_id().text
            return InsertIntoStream(target, ef, is_inner=is_inner, is_fault=is_fault)
        if self.try_kw("delete"):
            target = self.eat_id().text
            ef = OutputEventsFor.CURRENT
            if self.try_kw("for"):
                ef = OutputEventsFor(self._parse_event_type_kw())
            self.eat_kw("on")
            return DeleteStream(target, ef, on=self.parse_expression())
        if self.try_kw("update"):
            if self.try_kw("or"):
                self.eat_kw("insert")
                self.eat_kw("into")
                cls = UpdateOrInsertStream
            else:
                cls = UpdateStream
            target = self.eat_id().text
            ef = OutputEventsFor.CURRENT
            if self.try_kw("for"):
                ef = OutputEventsFor(self._parse_event_type_kw())
            assigns = []
            if self.try_kw("set"):
                while True:
                    var = self.parse_variable()
                    self.eat_op("=")
                    assigns.append(UpdateSetAssignment(var, self.parse_expression()))
                    if not self.try_op(","):
                        break
            self.eat_kw("on")
            return cls(target, ef, on=self.parse_expression(),
                       set_assignments=assigns)
        if self.try_kw("return"):
            ef = OutputEventsFor.CURRENT
            if self.at_kw("current", "expired", "all"):
                ef = OutputEventsFor(self._parse_event_type_kw())
            return ReturnStream(events_for=ef)
        return ReturnStream()

    # ------------------------------------------------- selector

    def parse_selector_body(self) -> Selector:
        sel = Selector()
        if self.try_op("*"):
            sel.select_all = True
            return sel
        while True:
            oa_pos = self.mark()
            expr = self.parse_expression()
            if self.try_kw("as"):
                rename = self.eat_id().text
            elif isinstance(expr, Variable):
                rename = expr.attribute
            elif isinstance(expr, AttributeFunction):
                rename = expr.name
            else:
                rename = f"_{len(sel.attributes)}"
            sel.attributes.append(
                set_pos(OutputAttribute(rename, expr), oa_pos))
            if not self.try_op(","):
                break
        return sel

    def _parse_selector_suffix(self, sel: Selector):
        if self.at_kw("group") and self.peek(1).is_kw("by"):
            self.next()
            self.next()
            while True:
                sel.group_by.append(self.parse_variable())
                if not self.try_op(","):
                    break
        if self.try_kw("having"):
            sel.having = self.parse_expression()
        if self.at_kw("order") and self.peek(1).is_kw("by"):
            self.next()
            self.next()
            while True:
                v = self.parse_variable()
                asc = True
                if self.try_kw("desc"):
                    asc = False
                elif self.try_kw("asc"):
                    asc = True
                sel.order_by.append(OrderByAttribute(v, asc))
                if not self.try_op(","):
                    break
        if self.try_kw("limit"):
            sel.limit = int(self.next().value)
        if self.try_kw("offset"):
            sel.offset = int(self.next().value)

    # ------------------------------------------------- input streams

    def parse_input_stream(self):
        # pattern / sequence detection:
        #   starts with 'every' / 'not', or 'id=' assignment, or contains
        #   '->' / ',' at this nesting level before 'select'
        if self.at_kw("every", "not") or \
           (self.peek().kind == "ID" and self.at_op("=", k=1)) or \
           self._scan_pattern_ahead():
            return self.parse_state_stream()
        left = self.parse_single_stream()
        unidir_left = self.try_kw("unidirectional")
        if self.at_kw(*_JOIN_START):
            return self.parse_join_rest(left, unidir_left)
        return left

    def _scan_pattern_ahead(self) -> bool:
        """Look ahead (no consumption) for '->' or top-level ',' before
        select/#window, which signals a pattern/sequence input."""
        depth = 0
        k = 0
        while True:
            t = self.peek(k)
            if t.kind == "EOF":
                return False
            if t.kind == "OP":
                if t.text in "([":
                    depth += 1
                elif t.text in ")]":
                    depth -= 1
                    if depth < 0:
                        return False
                elif t.text == "->":
                    return True
                elif t.text == "," and depth == 0:
                    return True
                elif t.text == ";":
                    return False
            elif t.kind == "ID" and depth == 0 and \
                    t.text.lower() in ("select", "insert", "delete", "update",
                                       "output", "join", "on", "within"):
                return False
            k += 1

    def parse_single_stream(self) -> SingleInputStream:
        s_pos = self.mark()
        is_inner = self.try_op("#")
        is_fault = (not is_inner) and self.try_op("!")
        sid = self.eat_id().text
        s = SingleInputStream(sid, is_inner=is_inner, is_fault=is_fault)
        set_pos(s, s_pos)
        self._parse_stream_handlers(s)
        if self.try_kw("as"):
            s.stream_ref = self.eat_id().text
        return s

    def _parse_stream_handlers(self, s: SingleInputStream):
        while True:
            h_pos = self.mark()
            if self.at_op("["):
                self.eat_op("[")
                s.handlers.append(Filter(self.parse_expression()))
                self.eat_op("]")
            elif self.at_op("#"):
                self.eat_op("#")
                if self.at_kw("window") and self.at_op(".", k=1):
                    self.next()
                    self.next()
                    ns, name, params = self._parse_window_call()
                    s.handlers.append(WindowHandler(ns, name, params))
                else:
                    ns, name, params = self._parse_window_call()
                    s.handlers.append(StreamFunctionHandler(ns, name, params))
            else:
                break
            set_pos(s.handlers[-1], h_pos)

    def parse_join_rest(self, left: SingleInputStream,
                        unidir_left: bool) -> JoinInputStream:
        jt = JoinType.JOIN
        if self.try_kw("left"):
            self.eat_kw("outer")
            self.eat_kw("join")
            jt = JoinType.LEFT_OUTER
        elif self.try_kw("right"):
            self.eat_kw("outer")
            self.eat_kw("join")
            jt = JoinType.RIGHT_OUTER
        elif self.try_kw("full"):
            self.eat_kw("outer")
            self.eat_kw("join")
            jt = JoinType.FULL_OUTER
        else:
            self.try_kw("inner")
            self.eat_kw("join")
        right = self.parse_single_stream()
        unidir_right = self.try_kw("unidirectional")
        trigger = EventTrigger.ALL
        if unidir_left:
            trigger = EventTrigger.LEFT
        elif unidir_right:
            trigger = EventTrigger.RIGHT
        on = None
        if self.try_kw("on"):
            on = self.parse_expression()
        within = None
        per = None
        if self.try_kw("within"):
            within = self._parse_within_expr()
            if self.try_op(","):
                within = (within, self._parse_within_expr())
        if self.try_kw("per"):
            per = self.parse_expression()
        return JoinInputStream(left, jt, right, on, trigger, within, per)

    def _parse_within_expr(self):
        if self.peek().kind in ("INT", "LONG") and self.peek(1).kind == "ID" \
                and self.peek(1).text.lower() in _TIME_UNITS_MS:
            return TimeConstant(self._parse_time_value())
        return self.parse_expression()

    # ------------------------------------------------- patterns / sequences

    def parse_state_stream(self) -> StateInputStream:
        elements: List = []
        seps: List[str] = []
        elements.append(self.parse_pattern_element())
        while True:
            if self.try_op("->"):
                seps.append("->")
            elif self.at_op(",") :
                self.next()
                seps.append(",")
            else:
                break
            elements.append(self.parse_pattern_element())
        state_type = StateType.SEQUENCE if "," in seps else StateType.PATTERN
        # right-fold into NextStateElement chain
        state = elements[-1]
        for el in reversed(elements[:-1]):
            state = NextStateElement(state=el, next=state)
        within_ms = None
        if self.try_kw("within"):
            within_ms = self._parse_time_value()
        if within_ms is None and len(elements) == 1 and \
                not isinstance(state, EveryStateElement):
            # `(chain) within t` — the group spans the whole pattern, so
            # the group-scoped within IS the pattern within
            w = getattr(state, "within_ms", None)
            if w is not None:
                state.within_ms = None
                within_ms = w
        for el in elements:
            # a group-scoped within on a partial non-every group has no
            # runtime support — surface it rather than dropping it silently
            if not isinstance(el, EveryStateElement) and \
                    getattr(el, "within_ms", None) is not None:
                t = self.peek()
                raise SiddhiParserException(
                    "`within` on a partial pattern group is not supported; "
                    "attach it to the whole pattern or an `every` group",
                    t.line, t.col)
        return StateInputStream(state_type=state_type, state=state,
                                within_ms=within_ms)

    def parse_pattern_element(self):
        el_pos = self.mark()
        return set_pos(self._parse_pattern_element_inner(), el_pos)

    def _parse_pattern_element_inner(self):
        if self.try_kw("every"):
            inner = self.parse_pattern_unit()
            # `every (...) within t`: the group-scoped within parsed inside
            # parse_pattern_unit rides the every element
            w = getattr(inner, "within_ms", None)
            if w is not None:
                inner.within_ms = None
                return EveryStateElement(state=inner, within_ms=w)
            return EveryStateElement(state=inner)
        return self.parse_pattern_unit()

    def parse_pattern_unit(self):
        if self.at_op("("):
            self.eat_op("(")
            inner = self.parse_state_stream_group()
            self.eat_op(")")
            if self.try_kw("within"):
                inner.within_ms = self._parse_time_value()
            return self._maybe_logical(inner)
        if self.try_kw("not"):
            absent = self._parse_absent()
            return self._maybe_logical(absent)
        base = self._parse_stream_state()
        base = self._maybe_count(base)
        return self._maybe_logical(base)

    def parse_state_stream_group(self):
        """Inside parentheses: a full pattern chain (no 'within' consumption)."""
        elements = [self.parse_pattern_element()]
        seps = []
        while True:
            if self.try_op("->"):
                seps.append("->")
            elif self.at_op(","):
                self.next()
                seps.append(",")
            else:
                break
            elements.append(self.parse_pattern_element())
        state = elements[-1]
        for el in reversed(elements[:-1]):
            state = NextStateElement(state=el, next=state)
        return state

    def _parse_absent(self) -> AbsentStreamStateElement:
        stream = self._parse_stream_state_raw()
        el = AbsentStreamStateElement(stream=stream.stream)
        if self.try_kw("for"):
            el.waiting_time_ms = self._parse_time_value()
        return el

    def _parse_stream_state(self) -> StreamStateElement:
        return self._parse_stream_state_raw()

    def _parse_stream_state_raw(self) -> StreamStateElement:
        s_pos = self.mark()
        ref = None
        if self.peek().kind == "ID" and self.at_op("=", k=1):
            ref = self.eat_id().text
            self.eat_op("=")
        sid = self.eat_id().text
        s = SingleInputStream(sid, stream_ref=ref)
        set_pos(s, s_pos)
        self._parse_stream_handlers(s)
        return set_pos(StreamStateElement(stream=s), s_pos)

    def _maybe_count(self, base: StreamStateElement):
        ANY = CountStateElement.ANY
        if self.at_op("<"):
            # lookahead to confirm <m:n> / <m> / <:n> / <m:>
            # (avoid treating compare ops)
            if self.peek(1).kind in ("INT", "LONG") or \
                    (self.at_op(":", k=1) and
                     self.peek(2).kind in ("INT", "LONG")):
                self.eat_op("<")
                if self.peek().kind in ("INT", "LONG"):
                    mn = int(self.next().value)
                else:
                    mn = 0              # <:n> — max-only bound
                mx = mn
                if self.try_op(":"):
                    if self.peek().kind in ("INT", "LONG"):
                        mx = int(self.next().value)
                    else:
                        mx = ANY
                self.eat_op(">")
                return CountStateElement(state=base, min_count=mn, max_count=mx)
            return base
        if self.try_op("+"):
            return CountStateElement(state=base, min_count=1, max_count=ANY)
        if self.try_op("*"):
            return CountStateElement(state=base, min_count=0, max_count=ANY)
        if self.try_op("?"):
            return CountStateElement(state=base, min_count=0, max_count=1)
        return base

    def _maybe_logical(self, left):
        if self.at_kw("and"):
            self.next()
            if self.try_kw("not"):
                right = self._parse_absent()
            else:
                right = self._parse_stream_state()
            return LogicalStateElement(state1=left, op=LogicalOp.AND, state2=right)
        if self.at_kw("or"):
            self.next()
            if self.try_kw("not"):
                right = self._parse_absent()
            else:
                right = self._parse_stream_state()
            return LogicalStateElement(state1=left, op=LogicalOp.OR, state2=right)
        return left

    # ------------------------------------------------- partition

    def parse_partition(self, anns: List[Annotation]) -> Partition:
        p_pos = self.mark()
        self.eat_kw("partition")
        self.eat_kw("with")
        self.eat_op("(")
        p = Partition(annotations=anns)
        set_pos(p, p_pos)
        while not self.at_op(")"):
            pt_pos = self.mark()
            expr = self.parse_expression()
            if self.try_kw("as"):
                # range partition: cond as 'label' (or cond as 'label')* of Stream
                label = self.next().value
                ranges = [RangePartitionProperty(label, expr)]
                while self.try_kw("or"):
                    c = self.parse_expression()
                    self.eat_kw("as")
                    ranges.append(RangePartitionProperty(self.next().value, c))
                self.eat_kw("of")
                sid = self.eat_id().text
                p.partition_types.append(
                    set_pos(RangePartitionType(sid, ranges), pt_pos))
            else:
                self.eat_kw("of")
                sid = self.eat_id().text
                p.partition_types.append(
                    set_pos(ValuePartitionType(sid, expr), pt_pos))
            if not self.try_op(","):
                break
        self.eat_op(")")
        self.eat_kw("begin")
        while not self.at_kw("end"):
            anns_q = self.parse_annotations()
            p.queries.append(self.parse_query(anns_q))
            while self.try_op(";"):
                pass
        self.eat_kw("end")
        return p

    # ------------------------------------------------- store (on-demand) query

    def parse_store_query(self) -> StoreQuery:
        sq = StoreQuery()
        if self.try_kw("from"):
            store_id = self.eat_id().text
            st = InputStore(store_id)
            if self.try_kw("as"):
                st.store_ref = self.eat_id().text
            if self.try_kw("on"):
                st.on = self.parse_expression()
            if self.try_kw("within"):
                lo = self._parse_within_operand()
                if self.try_op(","):
                    hi = self._parse_within_operand()
                else:
                    hi = None
                st.within = (lo, hi)
            if self.try_kw("per"):
                st.per = self.parse_expression()
            sq.input_store = st
            if self.try_kw("select"):
                sq.selector = self.parse_selector_body()
            else:
                sq.selector = Selector(select_all=True)
            self._parse_selector_suffix(sq.selector)
            out = self.parse_output_action()
            if isinstance(out, DeleteStream):
                sq.type = StoreQueryType.DELETE
            elif isinstance(out, UpdateOrInsertStream):
                sq.type = StoreQueryType.UPDATE_OR_INSERT
            elif isinstance(out, UpdateStream):
                sq.type = StoreQueryType.UPDATE
            elif isinstance(out, InsertIntoStream):
                sq.type = StoreQueryType.INSERT
            else:
                sq.type = StoreQueryType.FIND
            sq.output_stream = out if not isinstance(out, ReturnStream) else None
            return sq
        # `select <values> insert into T` form
        self.eat_kw("select")
        sq.selector = self.parse_selector_body()
        sq.type = StoreQueryType.INSERT
        sq.output_stream = self.parse_output_action()
        return sq

    def _parse_within_operand(self):
        t = self.peek()
        if t.kind == "STRING":
            self.next()
            return Constant(t.value, "string")
        return self.parse_expression()

    # ------------------------------------------------- expressions

    def parse_expression(self) -> Expression:
        return self._parse_or()

    def _parse_or(self) -> Expression:
        left = self._parse_and()
        while self.at_kw("or"):
            self.next()
            left = Or(left, self._parse_and())
        return left

    def _parse_and(self) -> Expression:
        left = self._parse_not()
        while self.at_kw("and"):
            self.next()
            left = And(left, self._parse_not())
        return left

    def _parse_not(self) -> Expression:
        if self.at_kw("not"):
            self.next()
            return Not(self._parse_not())
        return self._parse_comparison()

    _CMP = {"<": CompareOp.LT, ">": CompareOp.GT, "<=": CompareOp.LTE,
            ">=": CompareOp.GTE, "==": CompareOp.EQ, "!=": CompareOp.NEQ}

    def _parse_comparison(self) -> Expression:
        left = self._parse_addsub()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.text in self._CMP:
                self.next()
                left = Compare(left, self._CMP[t.text], self._parse_addsub())
            elif self.at_kw("is") and self.peek(1).is_kw("null"):
                self.next()
                self.next()
                left = self._make_is_null(left)
            elif self.at_kw("in"):
                self.next()
                left = In(left, self.eat_id().text)
            else:
                return left

    @staticmethod
    def _make_is_null(left: Expression) -> IsNull:
        # `e1 is null` on a bare stream reference inside patterns
        if isinstance(left, Variable) and left.stream_id is None:
            return IsNull(None, stream_id=left.attribute,
                          stream_index=left.stream_index)
        return IsNull(left)

    def _parse_addsub(self) -> Expression:
        left = self._parse_muldiv()
        while self.at_op("+", "-"):
            op = MathOp.ADD if self.next().text == "+" else MathOp.SUB
            left = MathExpr(op, left, self._parse_muldiv())
        return left

    def _parse_muldiv(self) -> Expression:
        left = self._parse_unary()
        while self.at_op("*", "/", "%"):
            t = self.next().text
            op = {"*": MathOp.MUL, "/": MathOp.DIV, "%": MathOp.MOD}[t]
            left = MathExpr(op, left, self._parse_unary())
        return left

    def _parse_unary(self) -> Expression:
        if self.at_op("-"):
            self.next()
            inner = self._parse_unary()
            if isinstance(inner, Constant) and isinstance(inner.value, (int, float)):
                return Constant(-inner.value, inner.type_hint)
            return MathExpr(MathOp.SUB, Constant(0), inner)
        if self.at_op("+"):
            self.next()
            return self._parse_unary()
        if self.at_op("!"):
            self.next()
            return Not(self._parse_unary())
        return self._parse_primary()

    def _parse_primary(self) -> Expression:
        p_pos = self.mark()
        return set_pos(self._parse_primary_inner(), p_pos)

    def _parse_primary_inner(self) -> Expression:
        t = self.peek()
        if self.at_op("("):
            self.next()
            e = self.parse_expression()
            self.eat_op(")")
            return e
        if t.kind == "STRING":
            self.next()
            return Constant(t.value, "string")
        if t.kind in ("INT", "LONG", "FLOAT", "DOUBLE"):
            self.next()
            # time constant: INT followed by a time unit keyword
            if t.kind in ("INT", "LONG") and self.peek().kind == "ID" and \
                    self.peek().text.lower() in _TIME_UNITS_MS:
                total = int(t.value) * _TIME_UNITS_MS[self.next().text.lower()]
                while self.peek().kind in ("INT", "LONG") and \
                        self.peek(1).kind == "ID" and \
                        self.peek(1).text.lower() in _TIME_UNITS_MS:
                    v = int(self.next().value)
                    total += v * _TIME_UNITS_MS[self.next().text.lower()]
                return TimeConstant(total)
            kind_map = {"INT": "int", "LONG": "long", "FLOAT": "float",
                        "DOUBLE": "double"}
            return Constant(t.value, kind_map[t.kind])
        if t.kind == "ID":
            low = t.text.lower()
            if low in ("true", "false"):
                self.next()
                return Constant(low == "true", "bool")
            return self.parse_variable_or_function()
        raise SiddhiParserException(
            f"Unexpected token {t.text!r} in expression", t.line, t.col)

    def parse_variable_or_function(self) -> Expression:
        name = self.eat_id().text
        # namespace:function(...)
        if self.at_op(":") and self.peek(1).kind == "ID" and self.at_op("(", k=2):
            self.next()
            fname = self.eat_id().text
            return self._parse_function_args(name, fname)
        if self.at_op("("):
            return self._parse_function_args(None, name)
        # variable: name ([idx])? (.attr ([idx])? )*
        return self._parse_variable_rest(name)

    def _parse_function_args(self, ns: Optional[str], fname: str) -> AttributeFunction:
        self.eat_op("(")
        args = []
        while not self.at_op(")"):
            if self.try_op("*"):      # count(*) style
                continue
            args.append(self.parse_expression())
            if not self.try_op(","):
                break
        self.eat_op(")")
        return AttributeFunction(ns, fname, tuple(args))

    def parse_variable(self) -> Variable:
        t = self.peek()
        v_pos = self.mark()
        name = self.eat_id().text
        v = self._parse_variable_rest(name)
        if not isinstance(v, Variable):
            raise SiddhiParserException("Expected a variable reference",
                                        t.line, t.col)
        return set_pos(v, v_pos)

    def _parse_variable_rest(self, name: str) -> Variable:
        idx = None
        if self.at_op("[") and (self.peek(1).kind in ("INT", "LONG")
                                or self.peek(1).is_kw("last")):
            self.next()
            t = self.next()
            idx = LAST_INDEX if (t.kind == "ID") else int(t.value)
            # support `e1[last - 1]`
            if idx == LAST_INDEX and self.at_op("-"):
                self.next()
                k = int(self.next().value)
                idx = LAST_INDEX - k
            self.eat_op("]")
        if self.try_op("."):
            attr = self.eat_id().text
            return Variable(attr, stream_id=name, stream_index=idx)
        return Variable(name, stream_index=idx)

    # ------------------------------------------------- time values

    def _parse_time_value(self) -> int:
        """Parse `5 sec`, `1 min 30 sec`, or a bare integer (millis)."""
        t = self.peek()
        if t.kind not in ("INT", "LONG"):
            raise SiddhiParserException(
                f"Expected time value, found {t.text!r}", t.line, t.col)
        e = self._parse_primary()
        if isinstance(e, TimeConstant):
            return e.value
        if isinstance(e, Constant):
            return int(e.value)
        raise SiddhiParserException("Expected time constant", t.line, t.col)


# ------------------------------------------------------------------ facade
# (reference: SiddhiCompiler.java — parse/parseQuery/parseStreamDefinition/
#  parseStoreQuery/parseExpression entry points)

def parse(text: str) -> SiddhiApp:
    p = Parser(text)
    return p.parse_app()


def parse_query(text: str) -> Query:
    p = Parser(text)
    anns = p.parse_annotations()
    return p.parse_query(anns)


def parse_stream_definition(text: str) -> StreamDefinition:
    p = Parser(text)
    app = p.parse_app()
    return next(iter(app.stream_definitions.values()))


def parse_store_query(text: str) -> StoreQuery:
    p = Parser(text)
    return p.parse_store_query()


def parse_expression(text: str) -> Expression:
    return Parser(text).parse_expression()
