"""The reference's table corpora on the port (``core/table/``,
``core/query/output_callbacks.py``, ``in <table>``, the indexed join
probe), on the CPU.

Every scenario of ``test_tables.py``, ``test_tables_extended.py``,
``test_table_crud_corpus.py``, ``test_table_define_corpus.py``,
``test_table_index_corpus.py``, ``test_table_join_corpus.py``,
``test_table_primary_key_corpus.py``, ``test_table_set_corpus.py`` and
``test_index_probes.py`` drives the port through the module's own feed and
checks the module's own expected rows, and its own validation errors
(``torch_helpers.port_corpus``: the compiler's exceptions are the port's).
"""

import pytest

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

MODULES = {n: port_corpus(n) for n in (
    "test_tables", "test_tables_extended", "test_table_crud_corpus",
    "test_table_define_corpus", "test_table_index_corpus",
    "test_table_join_corpus", "test_table_primary_key_corpus",
    "test_table_set_corpus", "test_index_probes")}
CASES = [(n, t) for n, (_m, tests) in MODULES.items() for t in tests]


@pytest.mark.parametrize("module,name", CASES)
def test_table_corpus_on_port(module, name):
    getattr(MODULES[module][0], name)()
