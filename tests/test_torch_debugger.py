"""The debugger (``core/debugger.py``, ``SiddhiAppRuntime.debug()``) on the
port, held against the JAX package on the CPU.

The five debugger scenarios of ``tests/test_long_tail.py``: breakpoints
IN and OUT, ``next()`` single-stepping to an unacquired checkpoint, the
pump suspended until ``play()``, ``get_query_state`` while suspended at
OUT, and ``get_query_state`` itself. Each runs through both packages
(``torch_helpers.api``) with the reference's own checks; the checkpoints
hit (query, terminal, events decoded), the rows emitted and the query
state read are compared. A debugged app runs unfused in both.
"""

import threading
import time

import numpy as np

from torch_helpers import api, release_jax_programs  # noqa: F401 — autouse fixture

PKGS = ("jax", "torch")

FILTER_APP = """
define stream S (sym string, v int);
@info(name='q')
from S[v > 0] select sym, v insert into Out;
"""

WINDOW_APP = """
define stream S (sym string, v int);
@info(name='q')
from S#window.length(3) select sym, sum(v) as t insert into Out;
"""


def _debugger_cls(a):
    if a.pkg == "jax":
        from siddhi_tpu.core.debugger import SiddhiDebugger
    else:
        from siddhi_tpu_torch.core.debugger import SiddhiDebugger
    return SiddhiDebugger


def _collector(a):
    class Collector(a.StreamCallback):
        def __init__(self):
            super().__init__()
            self.events = []

        def receive(self, events):
            self.events.extend(events)

    return Collector()


def _both(scenario):
    got = {pkg: scenario(api(pkg)) for pkg in PKGS}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def _leaves(tree, path=()):
    """A state tree as sorted (path, dtype kind, values) leaves."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k], path + (k,)))
        return out
    a = np.asarray(tree)
    return [(path, a.dtype.kind, a.tolist())]


def _breakpoints(a):
    D = _debugger_cls(a)
    m = a.SiddhiManager()
    rt = m.create_siddhi_app_runtime(FILTER_APP)
    hits = []

    def cb(events, name, terminal, d):
        hits.append((name, [tuple(e.data) for e in events]))
        d.play()

    out = _collector(a)
    rt.add_callback("Out", out)
    dbg = rt.debug()
    dbg.set_debugger_callback(cb)
    dbg.acquire_break_point("q", D.QueryTerminal.IN)
    dbg.acquire_break_point("q", D.QueryTerminal.OUT)
    h = rt.get_input_handler("S")
    h.send(["a", 1])
    h.send(["b", -1])
    assert ("q:IN", [("a", 1)]) in hits and ("q:OUT", [("a", 1)]) in hits
    n_before = len(hits)
    dbg.release_all_break_points()
    h.send(["c", 2])
    m.shutdown()
    assert len(hits) == n_before
    return hits, [tuple(e.data) for e in out.events]


def test_debugger_breakpoints():
    hits, rows = _both(_breakpoints)
    assert rows == [("a", 1), ("c", 2)]
    assert [n for n, _e in hits] == ["q:IN", "q:OUT", "q:IN"]


def _next_steps(a):
    D = _debugger_cls(a)
    m = a.SiddhiManager()
    rt = m.create_siddhi_app_runtime(FILTER_APP)
    hits = []

    def cb(events, name, terminal, d):
        hits.append(name)
        if terminal is D.QueryTerminal.IN:
            d.next()
        else:
            d.play()

    rt.add_callback("Out", _collector(a))
    dbg = rt.debug()
    dbg.set_debugger_callback(cb)
    dbg.acquire_break_point("q", D.QueryTerminal.IN)
    rt.get_input_handler("S").send(["a", 1])
    m.shutdown()
    assert hits == ["q:IN", "q:OUT"]
    return hits


def test_debugger_next_single_steps_to_unacquired_checkpoint():
    _both(_next_steps)


def _suspends(a):
    D = _debugger_cls(a)
    m = a.SiddhiManager()
    rt = m.create_siddhi_app_runtime(FILTER_APP)
    out = _collector(a)
    rt.add_callback("Out", out)
    dbg = rt.debug()
    fired = threading.Event()
    dbg.set_debugger_callback(lambda events, name, terminal, d: fired.set())
    dbg.acquire_break_point("q", D.QueryTerminal.IN)
    h = rt.get_input_handler("S")
    t = threading.Thread(target=lambda: h.send(["a", 1]), daemon=True)
    t.start()
    assert fired.wait(10.0)
    time.sleep(0.2)
    suspended = t.is_alive() and not out.events
    dbg.play()
    t.join(10.0)
    assert suspended and not t.is_alive()
    rows = [tuple(e.data) for e in out.events]
    m.shutdown()
    assert rows == [("a", 1)]
    return suspended, rows


def test_debugger_suspends_pump_until_play():
    _both(_suspends)


def _state_at_out(a):
    D = _debugger_cls(a)
    m = a.SiddhiManager()
    rt = m.create_siddhi_app_runtime(WINDOW_APP)
    rt.add_callback("Out", _collector(a))
    dbg = rt.debug()
    fired = threading.Event()
    dbg.set_debugger_callback(lambda *args: fired.set())
    dbg.acquire_break_point("q", D.QueryTerminal.OUT)
    h = rt.get_input_handler("S")
    t = threading.Thread(target=lambda: h.send(["a", 1]), daemon=True)
    t.start()
    assert fired.wait(10.0)
    st = dbg.get_query_state("q")     # the pump is suspended inside the lock
    assert "state" in st
    dbg.play()
    t.join(10.0)
    assert not t.is_alive()
    m.shutdown()
    return sorted(st), _leaves(st["state"])


def test_debugger_get_query_state_while_suspended_at_out():
    _both(_state_at_out)


def _query_state(a):
    m = a.SiddhiManager()
    rt = m.create_siddhi_app_runtime(WINDOW_APP)
    rt.add_callback("Out", _collector(a))
    dbg = rt.debug()
    h = rt.get_input_handler("S")
    for s, v in (("a", 1), ("b", 5), ("a", 2), ("c", 4)):
        h.send([s, v])
    st = dbg.get_query_state("q")
    assert st["state"] is not None
    m.shutdown()
    return _leaves(st["state"]), st["host_window"]


def test_debugger_get_query_state():
    leaves, host_window = _both(_query_state)
    assert leaves and host_window is None
