"""SiddhiQL tokenizer.

Token classes mirror the lexer rules of the reference grammar
(``siddhi-query-compiler/src/main/antlr4/.../SiddhiQL.g4``): case-insensitive
keywords, case-sensitive identifiers (optionally backtick-quoted),
single/double/triple-quoted strings, int/long/float/double literals,
``--`` line comments and ``/* */`` block comments.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from siddhi_tpu_torch.compiler.errors import SiddhiParserException

# Multi-char operators first (maximal munch).
_OPERATORS = [
    "->", "<=", ">=", "==", "!=", "<:", ":>",
    "(", ")", "[", "]", "<", ">", ",", ";", ":", ".", "@",
    "+", "-", "*", "/", "%", "=", "#", "!", "?",
]

KEYWORDS = {
    "define", "stream", "table", "window", "trigger", "aggregation", "function",
    "from", "select", "as", "insert", "into", "delete", "update", "set", "return",
    "group", "by", "having", "order", "asc", "desc", "limit", "offset",
    "output", "snapshot", "all", "first", "last", "current", "expired", "events", "every",
    "at", "and", "or", "not", "in", "is", "null", "true", "false",
    "join", "inner", "outer", "left", "right", "full", "unidirectional", "on",
    "within", "per", "for", "of", "partition", "with", "begin", "end", "range",
    "aggregate", "string", "int", "long", "float", "double", "bool", "object",
    "seconds", "second", "sec", "minutes", "minute", "min", "hours", "hour",
    "days", "day", "weeks", "week", "months", "month", "years", "year",
    "millisecond", "milliseconds", "millisec", "ms",
}

_TIME_UNIT_MS = {
    "ms": 1, "millisec": 1, "millisecond": 1, "milliseconds": 1,
    "sec": 1000, "second": 1000, "seconds": 1000,
    "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "hour": 3_600_000, "hours": 3_600_000,
    "day": 86_400_000, "days": 86_400_000,
    "week": 604_800_000, "weeks": 604_800_000,
    "month": 2_592_000_000, "months": 2_592_000_000,  # 30 days
    "year": 31_536_000_000, "years": 31_536_000_000,  # 365 days
}


def time_unit_ms(word: str) -> int:
    return _TIME_UNIT_MS[word.lower()]


def is_time_unit(word: str) -> bool:
    return word.lower() in _TIME_UNIT_MS


@dataclass
class Token:
    kind: str  # 'id', 'keyword', 'int', 'long', 'float', 'double', 'string', 'op', 'eof'
    text: str
    value: object
    line: int
    col: int

    def is_kw(self, *kws: str) -> bool:
        return self.kind == "keyword" and self.text.lower() in kws

    def is_op(self, *ops: str) -> bool:
        return self.kind == "op" and self.text in ops


def tokenize(source: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(source)
    line, col = 1, 1

    def advance(k: int = 1):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and source[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = source[i]
        # whitespace
        if c in " \t\r\n":
            advance()
            continue
        # comments
        if source.startswith("--", i):
            while i < n and source[i] != "\n":
                advance()
            continue
        if source.startswith("/*", i):
            start_line, start_col = line, col
            advance(2)
            while i < n and not source.startswith("*/", i):
                advance()
            if i >= n:
                raise SiddhiParserException("unterminated block comment", start_line, start_col)
            advance(2)
            continue
        # strings
        if c in "'\"":
            start_line, start_col = line, col
            if source.startswith('"""', i):
                advance(3)
                j = source.find('"""', i)
                if j < 0:
                    raise SiddhiParserException("unterminated string", start_line, start_col)
                text = source[i:j]
                advance(j - i + 3)
                tokens.append(Token("string", text, text, start_line, start_col))
                continue
            quote = c
            advance()
            buf = []
            while i < n and source[i] != quote:
                if source[i] == "\n":
                    raise SiddhiParserException("unterminated string", start_line, start_col)
                buf.append(source[i])
                advance()
            if i >= n:
                raise SiddhiParserException("unterminated string", start_line, start_col)
            advance()  # closing quote
            text = "".join(buf)
            tokens.append(Token("string", text, text, start_line, start_col))
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and source[i + 1].isdigit()):
            start_line, start_col = line, col
            j = i
            while j < n and source[j].isdigit():
                j += 1
            is_decimal = False
            if j < n and source[j] == "." and j + 1 < n and source[j + 1].isdigit():
                is_decimal = True
                j += 1
                while j < n and source[j].isdigit():
                    j += 1
            if j < n and source[j] in "eE" and (
                (j + 1 < n and source[j + 1].isdigit())
                or (j + 2 < n and source[j + 1] in "+-" and source[j + 2].isdigit())
            ):
                is_decimal = True
                j += 1
                if source[j] in "+-":
                    j += 1
                while j < n and source[j].isdigit():
                    j += 1
            text = source[i:j]
            suffix = source[j].lower() if j < n else ""
            if suffix == "l" and not is_decimal:
                advance(j - i + 1)
                tokens.append(Token("long", text, int(text), start_line, start_col))
            elif suffix == "f":
                advance(j - i + 1)
                tokens.append(Token("float", text, float(text), start_line, start_col))
            elif suffix == "d":
                advance(j - i + 1)
                tokens.append(Token("double", text, float(text), start_line, start_col))
            elif is_decimal:
                advance(j - i)
                tokens.append(Token("double", text, float(text), start_line, start_col))
            else:
                advance(j - i)
                tokens.append(Token("int", text, int(text), start_line, start_col))
            continue
        # script body `{ ... }` — one token, as in the reference grammar's
        # SCRIPT lexer rule (used only for `define function` bodies)
        if c == "{":
            start_line, start_col = line, col
            depth = 0
            j = i
            in_quote = ""
            while j < n:
                ch = source[j]
                if in_quote:
                    if ch == in_quote:
                        in_quote = ""
                elif ch in "'\"":
                    in_quote = ch
                elif ch == "{":
                    depth += 1
                elif ch == "}":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            if j >= n:
                raise SiddhiParserException("unterminated script body", start_line, start_col)
            body = source[i + 1 : j]
            advance(j - i + 1)
            tokens.append(Token("script", body, body, start_line, start_col))
            continue
        # backtick-quoted identifier
        if c == "`":
            start_line, start_col = line, col
            advance()
            j = source.find("`", i)
            if j < 0:
                raise SiddhiParserException("unterminated quoted identifier", start_line, start_col)
            text = source[i:j]
            advance(j - i + 1)
            tokens.append(Token("id", text, text, start_line, start_col))
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            start_line, start_col = line, col
            j = i
            while j < n and (source[j].isalnum() or source[j] == "_"):
                j += 1
            text = source[i:j]
            advance(j - i)
            kind = "keyword" if text.lower() in KEYWORDS else "id"
            tokens.append(Token(kind, text, text, start_line, start_col))
            continue
        # operators
        for op in _OPERATORS:
            if source.startswith(op, i):
                tokens.append(Token("op", op, op, line, col))
                advance(len(op))
                break
        else:
            raise SiddhiParserException(f"unexpected character '{c}'", line, col)

    tokens.append(Token("eof", "", None, line, col))
    return tokens
