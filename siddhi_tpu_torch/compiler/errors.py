"""Compiler error types with line/column context.

Mirrors the role of reference ``internal/SiddhiErrorListener.java`` — parse
errors carry the offending line/column and a context snippet.
"""

from __future__ import annotations


class SiddhiParserException(Exception):
    def __init__(self, message: str, line: int = -1, col: int = -1, context: str = ""):
        self.line = line
        self.col = col
        self.context = context
        loc = f" at line {line}:{col}" if line >= 0 else ""
        ctx = f" near '{context}'" if context else ""
        super().__init__(f"{message}{loc}{ctx}")


class SiddhiAppValidationException(Exception):
    pass


class DuplicateDefinitionException(SiddhiAppValidationException):
    """Conflicting (re)definition of a stream/table/window id — same-id
    redefinitions are legal only when attribute lists are identical
    (reference ``AbstractDefinition.checkEquivalency``)."""
