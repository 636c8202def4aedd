"""The reference's join corpora on the port (``core/query/join_runtime.py``,
``core/join/engine.py``), on the CPU.

Every scenario of ``test_joins.py``, ``test_joins_extended.py``,
``test_join_partition_corpus.py`` and ``test_custom_join_window_corpus.py``
drives the port through the module's own feed and checks the module's own
expected rows (``torch_helpers.port_corpus``), the two that join an
incremental aggregation included.
"""

import pytest

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

MODULES = {n: port_corpus(n) for n in (
    "test_joins", "test_joins_extended", "test_join_partition_corpus",
    "test_custom_join_window_corpus")}
CASES = [(n, t) for n, (_m, tests) in MODULES.items() for t in tests]


@pytest.mark.parametrize("module,name", CASES)
def test_join_corpus_on_port(module, name):
    getattr(MODULES[module][0], name)()
