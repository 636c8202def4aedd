"""Compiler facade.

Mirrors reference ``SiddhiCompiler.java`` static methods: ``parse``:63,
``parseQuery``:145, ``parseOnDemandQuery``:193, ``updateVariables``:233
(``${var}`` substitution from environment / system properties).
"""

from __future__ import annotations

import os
import re

from siddhi_tpu_torch.compiler.errors import SiddhiParserException
from siddhi_tpu_torch.compiler.parser import Parser
from siddhi_tpu_torch.compiler.tokenizer import tokenize
from siddhi_tpu_torch.query_api.execution import OnDemandQuery, Query
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp

_VAR_RE = re.compile(r"\$\{(\w+)\}")


class SiddhiCompiler:
    @staticmethod
    def update_variables(siddhi_app: str) -> str:
        """Substitute ``${var}`` from os.environ (reference
        ``SiddhiCompiler.updateVariables:233`` reads env then system props)."""

        def repl(m: re.Match) -> str:
            name = m.group(1)
            value = os.environ.get(name)
            if value is None:
                raise SiddhiParserException(
                    f"no system or environment variable found for '${{{name}}}'"
                )
            return value

        return _VAR_RE.sub(repl, siddhi_app)

    @staticmethod
    def parse(source: str) -> SiddhiApp:
        return Parser(tokenize(source)).parse_siddhi_app()

    @staticmethod
    def parse_query(source: str) -> Query:
        p = Parser(tokenize(source))
        annotations = p.parse_annotations()
        return p.parse_query(annotations)

    @staticmethod
    def parse_on_demand_query(source: str) -> OnDemandQuery:
        return Parser(tokenize(source)).parse_on_demand_query()

    # Java-style aliases
    updateVariables = update_variables
    parseQuery = parse_query
    parseOnDemandQuery = parse_on_demand_query
