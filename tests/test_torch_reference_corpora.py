"""Every reference corpus no other port test runs, on the port, on the CPU.

Each module below drives the port through its own feed and checks its own
expected rows (``torch_helpers.port_corpus``: the reference's outputs, as
the module asserts them of the reference). One parametrised test runs
every (corpus, scenario):

- the scenarios ``port_corpus`` returns (the module's tests that take no
  argument);
- each case of a parametrised test, with the parameters read from the
  function's own ``pytestmark`` (stacked marks multiply, as pytest
  multiplies them);
- the tests that take a pytest fixture (``caplog``), with the fixture.

``test_managment_corpus`` holds the management API (``validate_siddhi_app``,
``create_sandbox_siddhi_app_runtime``, ``get_queries``/``is_stateful``)
and ``test_transport`` the sandbox that strips transports and stores.

No scenario of these modules is left out: none builds a reference manager
of its own, and every parametrised case runs. The tolerance is each
module's own.
"""

import inspect
import itertools

import pytest
import torch
from _pytest.mark.structures import ParameterSet

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

torch.set_num_threads(1)

CORPORA = (
    "test_filter_corpus", "test_in_condition", "test_post_window_filters",
    "test_aggregator_ext_corpus", "test_differential_r4", "test_differential_r5",
    "test_differential_r6", "test_event_ratelimit_corpus",
    "test_orderby_limit_corpus", "test_query_core_corpus", "test_querysync_corpus",
    "test_playback_corpus", "test_snapshot_ratelimit_corpus", "test_stream_functions",
    "test_time_ratelimit_corpus", "test_windows", "test_windows_extra",
    "test_windows_new", "test_interactions", "test_integration_capstone",
    "test_grammar_coverage", "test_property_chunking", "test_managment_corpus",
    "test_transport")

# the pytest fixtures a scenario of these modules may take
FIXTURES = {"caplog"}

MODULES = {n: port_corpus(n) for n in CORPORA}


def _parametrized(fn):
    """Every kwargs dict of ``fn``'s parametrize marks (their product)."""
    axes = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        rows = []
        for v in values:
            if isinstance(v, ParameterSet):
                v = v.values
            elif len(names) == 1:
                v = (v,)
            rows.append(dict(zip(names, v)))
        axes.append(rows)
    return [dict(kv for part in combo for kv in part.items())
            for combo in itertools.product(*axes)]


def _cases():
    cases = []
    for module, (mod, plain) in MODULES.items():
        for name in plain:
            cases.append(pytest.param(module, name, None, id=f"{module}::{name}"))
        for name in sorted(k for k, v in vars(mod).items()
                           if k.startswith("test_") and callable(v) and k not in plain):
            fn = getattr(mod, name)
            if any(m.name == "parametrize" for m in getattr(fn, "pytestmark", [])):
                for i, kwargs in enumerate(_parametrized(fn)):
                    cases.append(pytest.param(module, name, kwargs,
                                              id=f"{module}::{name}[{i}]"))
            else:
                cases.append(pytest.param(module, name, {}, id=f"{module}::{name}"))
    return cases


CASES = _cases()


@pytest.mark.parametrize("module,name,kwargs", CASES)
def test_reference_corpus_on_port(module, name, kwargs, request):
    fn = getattr(MODULES[module][0], name)
    if kwargs is None:
        fn()
        return
    fixtures = [p for p in inspect.signature(fn).parameters if p not in kwargs]
    assert set(fixtures) <= FIXTURES, (module, name, fixtures)
    fn(**kwargs, **{p: request.getfixturevalue(p) for p in fixtures})

