"""siddhi_tpu_torch.compiler — SiddhiQL text front end.

Counterpart of the reference's siddhi-query-compiler module (ANTLR4 grammar +
visitor); here a hand-rolled tokenizer + recursive-descent parser emitting the
query_api object model.
"""
from .parser import (Parser, parse, parse_expression, parse_query,
                     parse_store_query, parse_stream_definition)
from .tokenizer import Token, tokenize


class SiddhiCompiler:
    """Facade matching the reference SiddhiCompiler static API
    (siddhi-query-compiler/.../SiddhiCompiler.java)."""
    parse = staticmethod(parse)
    parse_query = staticmethod(parse_query)
    parse_stream_definition = staticmethod(parse_stream_definition)
    parse_store_query = staticmethod(parse_store_query)
    parse_expression = staticmethod(parse_expression)
