"""SiddhiQL compiler: text -> query-api IR.

Fills the role of the reference's ``siddhi-query-compiler`` module
(ANTLR4 ``SiddhiQL.g4`` + ``SiddhiQLBaseVisitorImpl.java``), re-implemented
as a hand-written tokenizer + recursive-descent parser so no parser-generator
runtime is needed. Public entry points mirror ``SiddhiCompiler.java:63,145,193,233``.
"""

from siddhi_tpu_torch.compiler.compiler import SiddhiCompiler
from siddhi_tpu_torch.compiler.errors import SiddhiParserException
