"""The port's copy of the SiddhiQL compiler produces the same query-api
trees as the reference's. The two packages' classes are distinct, so trees
are compared recursively by class name and field values.

Inputs: the slice's apps, and every string literal handed to the
compiler in tests/test_compiler.py and tests/test_grammar_corpus.py
(collected from their syntax trees, so the corpus follows those files).
A string either side rejects must be rejected by both, with the same
exception class and message."""

import ast
import dataclasses
import enum
from pathlib import Path

import pytest
from torch_helpers import DISTINCT_GK_APP, PARTITIONED_APP

from siddhi_tpu.compiler import SiddhiCompiler as RefCompiler
from siddhi_tpu_torch.compiler import SiddhiCompiler as PortCompiler

TESTS = Path(__file__).resolve().parent
_PARSERS = ("parse", "parse_query")


def _corpus():
    """(file:line, source) of every literal app/query string the two
    compiler test files parse, in file order."""
    found = []
    for name in ("test_compiler.py", "test_grammar_corpus.py"):
        tree = ast.parse((TESTS / name).read_text())
        for node in ast.walk(tree):
            strings = []
            if isinstance(node, ast.Call):
                fn = node.func
                fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                if fname in _PARSERS and node.args:
                    strings.append(node.args[0])
                if fname == "parametrize" and len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.List):
                    strings.extend(node.args[1].elts)
            for s in strings:
                if isinstance(s, ast.Constant) and isinstance(s.value, str) \
                        and s.value.strip():
                    found.append((f"{name}:{s.lineno}", s.value))
    seen, out = set(), []
    for where, src in sorted(found, key=lambda x: x[0]):
        if src not in seen:
            seen.add(src)
            out.append((where, src))
    return out


CORPUS = _corpus() + [
    ("slice:partitioned", PARTITIONED_APP.format(W=1000)),
    ("slice:distinct_gk", DISTINCT_GK_APP),
]


def _parse(compiler, src):
    """The tree of ``src`` as an app, else as a query; else the error."""
    try:
        return compiler.parse(compiler.update_variables(src))
    except Exception:  # noqa: BLE001 — fall through to a single query
        pass
    try:
        return compiler.parse_query(src)
    except Exception as e:  # noqa: BLE001 — compared below
        return ("error", type(e).__name__, str(e))


def _same(a, b, path="$"):
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        assert (type(a).__name__, getattr(a, "name", a)) == \
            (type(b).__name__, getattr(b, "name", b)), path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert type(a).__name__ == type(b).__name__ and a == b, (path, a, b)


def test_corpus_is_large_enough():
    assert len(CORPUS) >= 32


@pytest.mark.parametrize("where,src", CORPUS, ids=[w for w, _ in CORPUS])
def test_port_compiler_builds_the_reference_tree(where, src):
    _same(_parse(PortCompiler, src), _parse(RefCompiler, src))
