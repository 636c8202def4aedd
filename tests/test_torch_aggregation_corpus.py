"""The reference's incremental aggregation corpora on the port
(``core/aggregation/incremental.py``, finds in ``core/query/on_demand.py``,
aggregation joins in ``core/query/join_runtime.py``, revisions in
``core/util/snapshot.py``), on the CPU.

Every scenario of ``test_aggregation_corpus.py``,
``test_aggregation_extended.py``, ``test_aggregation_incremental.py`` and
``test_aggregation_select_corpus.py`` (72 test functions, a parametrized
one with each of its cases) drives the port through the module's own feed
and checks the module's own expected rows (``torch_helpers.port_corpus``).
"""

import inspect

import pytest

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

MODULES = {n: port_corpus(n) for n in (
    "test_aggregation_corpus", "test_aggregation_extended",
    "test_aggregation_incremental", "test_aggregation_select_corpus")}


def _cases():
    """(module, function, kwargs): plain scenarios as ``port_corpus``
    lists them, and each case of a one-argument ``parametrize``."""
    cases, functions = [], set()
    for n, (mod, tests) in MODULES.items():
        for name, fn in sorted(vars(mod).items()):
            if not (name.startswith("test_") and inspect.isfunction(fn)):
                continue
            if name in tests:
                cases.append((n, name, {}))
                functions.add((n, name))
                continue
            for mark in getattr(fn, "pytestmark", []):
                if mark.name == "parametrize":
                    arg, values = mark.args
                    cases.extend((n, name, {arg: v}) for v in values)
                    functions.add((n, name))
    return cases, functions


CASES, FUNCTIONS = _cases()


def test_every_scenario_is_collected():
    """The four corpora hold 72 test functions; none is left out."""
    assert len(FUNCTIONS) == 72, len(FUNCTIONS)


@pytest.mark.parametrize("module,name,kwargs", CASES,
                         ids=[f"{m}-{n}-{i}" for i, (m, n, _k) in enumerate(CASES)])
def test_aggregation_corpus_on_port(module, name, kwargs):
    getattr(MODULES[module][0], name)(**kwargs)
