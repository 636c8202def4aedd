"""The reference's named-window, on-demand query and trigger corpora on
the port (``core/window/named_window.py``, ``core/query/on_demand.py``,
``core/trigger/trigger.py``), on the CPU.

Every scenario of ``test_named_window_corpus.py``,
``test_on_demand_store_corpus.py`` and ``test_trigger_corpus.py`` drives
the port through the module's own feed and checks the module's own
expected rows (``torch_helpers.port_corpus``).
"""

import pytest

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

MODULES = {n: port_corpus(n) for n in (
    "test_named_window_corpus", "test_on_demand_store_corpus",
    "test_trigger_corpus")}
CASES = [(n, t) for n, (_m, tests) in MODULES.items() for t in tests]


@pytest.mark.parametrize("module,name", CASES)
def test_store_corpus_on_port(module, name):
    getattr(MODULES[module][0], name)()
