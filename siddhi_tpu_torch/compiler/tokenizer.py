"""SiddhiQL tokenizer.

Counterpart of the lexer rules in the reference grammar
(modules/siddhi-query-compiler/src/main/antlr4/.../SiddhiQL.g4) — hand-rolled
rather than ANTLR-generated.  Keywords are case-insensitive; identifiers keep
their case; backtick-quoted identifiers are supported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..utils.errors import SiddhiParserException


@dataclass
class Token:
    kind: str       # ID STRING INT LONG FLOAT DOUBLE OP EOF
    text: str
    line: int
    col: int
    value: object = None
    pos: int = -1   # absolute offset into the source text

    def is_kw(self, *kws: str) -> bool:
        return self.kind == "ID" and self.text.lower() in kws

    def __repr__(self):
        return f"Token({self.kind},{self.text!r}@{self.line}:{self.col})"


# multi-char operators first (longest match wins)
_OPS = ["->", "==", "!=", "<=", ">=", "::", ":", ";", ",", ".", "(", ")", "[",
        "]", "{", "}", "@", "#", "+", "-", "*", "/", "%", "<", ">", "=", "!",
        "?"]


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(text)
    line, col = 1, 1

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and text[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = text[i]
        # whitespace
        if c in " \t\r\n":
            advance(1)
            continue
        # comments
        if text.startswith("--", i) or text.startswith("//", i):
            j = text.find("\n", i)
            advance((j - i) if j >= 0 else (n - i))
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                raise SiddhiParserException("Unterminated comment", line, col)
            advance(j + 2 - i)
            continue
        # strings
        if c in "'\"":
            if text.startswith(c * 3, i):
                j = text.find(c * 3, i + 3)
                if j < 0:
                    raise SiddhiParserException("Unterminated string", line, col)
                s = text[i + 3:j]
                toks.append(Token("STRING", s, line, col, s, i))
                advance(j + 3 - i)
                continue
            j = i + 1
            buf = []
            while j < n and text[j] != c:
                if text[j] == "\n":
                    break
                buf.append(text[j])
                j += 1
            if j >= n or text[j] != c:
                raise SiddhiParserException("Unterminated string", line, col)
            s = "".join(buf)
            toks.append(Token("STRING", s, line, col, s, i))
            advance(j + 1 - i)
            continue
        # backtick identifier
        if c == "`":
            j = text.find("`", i + 1)
            if j < 0:
                raise SiddhiParserException("Unterminated `identifier`", line, col)
            toks.append(Token("ID", text[i + 1:j], line, col, None, i))
            advance(j + 1 - i)
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            is_float = False
            while j < n and (text[j].isdigit() or text[j] == "."):
                if text[j] == ".":
                    # ".." is not part of a number; "1.e5" etc not supported
                    if j + 1 < n and text[j + 1] == ".":
                        break
                    if is_float:
                        break
                    is_float = True
                j += 1
            if j < n and text[j] in "eE" and (j + 1 < n and (text[j + 1].isdigit() or text[j + 1] in "+-")):
                is_float = True
                j += 1
                if text[j] in "+-":
                    j += 1
                while j < n and text[j].isdigit():
                    j += 1
            lit = text[i:j]
            kind, val = "INT", None
            if j < n and text[j] in "lL":
                kind, val = "LONG", int(float(lit)) if is_float else int(lit)
                j += 1
            elif j < n and text[j] in "fF":
                kind, val = "FLOAT", float(lit)
                j += 1
            elif j < n and text[j] in "dD":
                kind, val = "DOUBLE", float(lit)
                j += 1
            elif is_float:
                kind, val = "DOUBLE", float(lit)
            else:
                val = int(lit)
            toks.append(Token(kind, lit, line, col, val, i))
            advance(j - i)
            continue
        # identifiers / keywords
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (text[j].isalnum() or text[j] in "_$"):
                j += 1
            toks.append(Token("ID", text[i:j], line, col, None, i))
            advance(j - i)
            continue
        # operators
        for op in _OPS:
            if text.startswith(op, i):
                toks.append(Token("OP", op, line, col, None, i))
                advance(len(op))
                break
        else:
            raise SiddhiParserException(f"Unexpected character {c!r}", line, col)
    toks.append(Token("EOF", "", line, col, None, n))
    return toks
