"""The port's runtime sanitizers (``siddhi_tpu_torch/analysis/``) against
the reference's, on the CPU (and two checks on the card).

- The fourteen scenarios of ``tests/test_sanitizers.py`` on the port, with
  torch tensors where the reference plants jax arrays (and capturable
  steps where it plants a jitted one: the port captures only those): the host-pull guard
  on ``torch.Tensor`` (``float``/``int``/``bool``/``.item()`` raise, the
  batched pulls and ``allowed_pull()`` do not, inert without the env var,
  ``LazyColumns.pop``'s one explicit copy), the recapture watchdog (a new
  input spec after ``freeze_compiles()``, the compile budget, stable
  shapes), the checked lock (inversion, the declared direction, same rank
  and re-entry, per thread, the factory with and without the env var)
  and an engine run clean under sanitize.
- The eleven scenarios of ``tests/test_guards.py`` on the port: the
  guarded-by descriptors under sanitize, plain attributes off, rank
  validation either way, and the port's 2-worker cluster check run with
  ``SIDDHI_TPU_SANITIZE=1`` in its workers' environment too.
- Against the reference: every inversion's ``LockOrderError`` message is
  the reference's byte for byte (the autopilot rank names its module in
  each package), ``RANKS`` and ``EDGES`` are the reference's, every rank
  a ``make_lock`` site or a ``GUARDED_BY`` map of the port names is
  declared, and the six ranked sites and three guarded classes match the
  reference's. A fresh process armed at import runs an engine app with
  every descriptor installed and plants an unlocked read.
- On the card (marked ``cuda``): a planted ``.item()`` on a cuda tensor
  raises and one inside ``allowed_pull()`` does not; a new column spec
  after the freeze refuses its capture naming the key.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.analysis import lockorder, sanitize
from siddhi_tpu_torch.analysis.guards import GuardViolation, _GuardedField, guarded
from siddhi_tpu_torch.analysis.locks import CheckedRLock, LockOrderError, make_lock

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT = os.path.join(REPO, "siddhi_tpu_torch")


@pytest.fixture
def sanitized(monkeypatch):
    monkeypatch.setenv("SIDDHI_TPU_SANITIZE", "1")
    sanitize.enable()
    yield
    sanitize.disable()


# ------------------------------------------------------------ pull guard

def test_planted_host_pull_is_caught(sanitized):
    arr = torch.arange(4.0) + 1
    with pytest.raises(sanitize.HostPullError, match="host pull"):
        float(arr[0])
    with pytest.raises(sanitize.HostPullError):
        arr[0].item()
    with pytest.raises(sanitize.HostPullError):
        bool(arr[0] > 0)
    with pytest.raises(sanitize.HostPullError):
        int(arr[1])


def test_sanctioned_pulls_stay_allowed(sanitized):
    arr = torch.arange(4.0) * 2
    # the engine's batched pulls are explicit and allowed
    assert arr.cpu().numpy()[1] == 2.0
    assert arr.tolist()[2] == 4.0
    assert np.asarray(arr)[3] == 6.0
    # cold-path reads declare themselves
    with sanitize.allowed_pull():
        assert float(arr[0]) == 0.0


def test_pull_guard_inert_without_env(monkeypatch):
    monkeypatch.delenv("SIDDHI_TPU_SANITIZE", raising=False)
    sanitize.enable()
    arr = torch.arange(3.0)
    assert float(arr[2]) == 2.0     # no env var -> patched dunder passes


def test_lazycolumns_pop_is_explicit(sanitized):
    """The ``LazyColumns.pop`` meta pull (every drain's first touch) is one
    explicit copy, clean under the guard."""
    from siddhi_tpu_torch.core.event import LazyColumns

    out = LazyColumns({"__meta__": torch.tensor([0, -1, 3], dtype=torch.int64)})
    meta = out.pop("__meta__")
    assert isinstance(meta, np.ndarray) and meta[2] == 3


# ------------------------------------------------------- recompile guard

def _registry():
    from siddhi_tpu_torch.observability.telemetry import TelemetryRegistry

    return TelemetryRegistry()


def test_planted_post_warmup_recompile_is_caught(sanitized):
    tel = _registry()
    step = tel.instrument_jit(lambda x: x * 2, "test.step",
                              capturable=True)
    step(torch.ones(4))             # warmup compile
    sanitize.freeze_compiles()
    with pytest.raises(sanitize.RecompileError, match="test.step"):
        step(torch.ones(8))         # new input spec -> a compile -> raise
    sanitize.thaw_compiles()


def test_recompile_budget(sanitized, monkeypatch):
    monkeypatch.setenv("SIDDHI_TPU_SANITIZE_MAX_COMPILES", "2")
    tel = _registry()
    step = tel.instrument_jit(lambda x: x + 1, "test.budget",
                              capturable=True)
    step(torch.ones(2))
    step(torch.ones(4))             # compile 2: at budget, fine
    with pytest.raises(sanitize.RecompileError, match="test.budget"):
        step(torch.ones(8))         # compile 3: past budget
    # telemetry recorded every compile, not just the first
    assert tel.jit["test.budget"]["compiles"] >= 3


def test_stable_shapes_never_trip(sanitized):
    sanitize.freeze_compiles()
    try:
        tel = _registry()
        step = tel.instrument_jit(lambda x: x - 1, "test.stable",
                              capturable=True)
        sanitize.thaw_compiles()
        step(torch.ones(16))
        sanitize.freeze_compiles()
        for _ in range(5):
            step(torch.ones(16))    # the same spec: silent
    finally:
        sanitize.thaw_compiles()


# ------------------------------------------------------- lock-order shim

def test_lock_order_inversion_raises():
    pump, owner = CheckedRLock("pump"), CheckedRLock("owner")
    with pump:
        with pytest.raises(LockOrderError, match="owner.*pump"):
            with owner:
                pass


def test_lock_order_declared_direction_ok():
    barrier, owner, pump = (CheckedRLock("barrier"), CheckedRLock("owner"),
                            CheckedRLock("pump"))
    with barrier:
        with owner:
            with pump:
                pass
    # shard -> wal likewise
    with CheckedRLock("shard"):
        with CheckedRLock("wal"):
            pass


def test_lock_order_same_rank_and_reentry_ok():
    a, b = CheckedRLock("owner"), CheckedRLock("owner")
    with a:
        with a:         # re-entrant
            with b:     # same-rank chain (emit cascades)
                pass


def test_lock_order_is_per_thread():
    pump, owner = CheckedRLock("pump"), CheckedRLock("owner")
    errs = []

    def other():
        try:
            with owner:
                pass
        except Exception as e:      # pragma: no cover — would be a bug
            errs.append(e)

    with pump:
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert not errs


def test_make_lock_plain_without_env(monkeypatch):
    monkeypatch.delenv("SIDDHI_TPU_SANITIZE", raising=False)
    lk = make_lock("pump")
    assert isinstance(lk, type(threading.RLock()))
    with pytest.raises(ValueError, match="undeclared"):
        make_lock("nonsense")       # the port validates ranks off too


def test_make_lock_checked_with_env(monkeypatch):
    monkeypatch.setenv("SIDDHI_TPU_SANITIZE", "1")
    lk = make_lock("pump")
    assert isinstance(lk, CheckedRLock)
    with pytest.raises(ValueError, match="undeclared"):
        make_lock("nonsense")


def _collect(sink):
    from siddhi_tpu_torch import StreamCallback

    class _C(StreamCallback):
        def receive(self, events):
            sink.extend(events)

    return _C()


def test_engine_runs_clean_under_sanitize(monkeypatch):
    """A real app (pipelined, ranked locks active) runs a batch with every
    sanitizer armed and trips nothing."""
    from siddhi_tpu_torch.analysis import locks

    monkeypatch.setenv("SIDDHI_TPU_SANITIZE", "1")
    sanitize.enable()
    try:
        from siddhi_tpu_torch import SiddhiManager

        before = locks.acquisitions()
        m = SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime("""
define stream S (sym string, v long);
@info(name='q') from S#window.length(4)
  select sym, sum(v) as total group by sym insert into Out;
""")
        assert isinstance(rt._barrier, CheckedRLock)
        got = []
        rt.add_callback("Out", _collect(got))
        rt.start()
        h = rt.get_input_handler("S")
        for i in range(8):
            h.send([f"k{i % 2}", i])
        assert len(got) == 8
        m.shutdown()
        assert [e.data[1] for e in got] == [0, 1, 2, 4, 6, 8, 10, 12]
        assert locks.acquisitions() > before
    finally:
        sanitize.disable()


# ======================================================= guarded-by

def _plant():
    """A threaded-class stand-in with one guarded field, defined under
    whatever env the caller monkeypatched."""

    @guarded
    class Table:
        GUARDED_BY = {"_pending": "pump"}

        def __init__(self):
            self._lock = make_lock("pump")
            self._pending = {}

        def put(self, k, v):
            with self._lock:
                self._pending[k] = v

        def get(self, k):
            with self._lock:
                return self._pending.get(k)

    return Table


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("SIDDHI_TPU_SANITIZE", "1")


def test_unlocked_read_raises(armed):
    t = _plant()()
    t.put("a", 1)
    with pytest.raises(GuardViolation, match="unlocked read.*_pending"):
        _ = t._pending


def test_unlocked_write_raises(armed):
    t = _plant()()
    with pytest.raises(GuardViolation, match="unlocked write.*_pending"):
        t._pending = {}


def test_locked_access_passes(armed):
    t = _plant()()
    t.put("a", 1)
    assert t.get("a") == 1
    with t._lock:
        t._pending["b"] = 2     # direct access under the lock is fine
        assert t._pending == {"a": 1, "b": 2}


def test_constructor_is_exempt(armed):
    # __init__ populated _pending without the lock and did not raise
    t = _plant()()
    assert t.get("missing") is None


def test_violation_is_per_thread(armed):
    """Holding the rank on THIS thread does not license another."""
    t = _plant()()
    errs = []

    def other():
        try:
            _ = t._pending
        except GuardViolation as e:
            errs.append(e)

    with t._lock:
        th = threading.Thread(target=other)
        th.start()
        th.join()
    assert len(errs) == 1


def test_undeclared_rank_rejected(armed):
    with pytest.raises(ValueError, match="undeclared lock rank"):
        @guarded
        class Bad:
            GUARDED_BY = {"_x": "nonsense"}


def test_guarded_requires_own_declaration(armed):
    with pytest.raises(ValueError, match="no GUARDED_BY"):
        @guarded
        class Bare:
            pass


def test_values_round_trip_untouched(armed):
    """The descriptor stores by reference: nested containers and tensors
    come back identical."""
    t = _plant()()
    leaf = torch.arange(4)
    tree = {"rows": [leaf, (1, 2)], "meta": {"seq": 7}}
    t.put("snap", tree)
    with t._lock:
        got = t._pending["snap"]
    assert got is tree
    assert got["rows"][0] is leaf


def test_descriptors_go_inert_with_the_env_var(monkeypatch):
    """A class decorated under sanitize (a module first imported while a
    test set the env var) checks nothing once the env var is gone: its
    instances' locks are plain RLocks then."""
    monkeypatch.setenv("SIDDHI_TPU_SANITIZE", "1")
    cls = _plant()
    assert isinstance(vars(cls)["_pending"], _GuardedField)
    monkeypatch.delenv("SIDDHI_TPU_SANITIZE")
    t = cls()
    t._pending = {"x": 1}
    assert t._pending == {"x": 1}


def test_plain_attributes_without_env(monkeypatch):
    monkeypatch.delenv("SIDDHI_TPU_SANITIZE", raising=False)
    cls = _plant()
    assert not any(isinstance(v, _GuardedField) for v in vars(cls).values())
    t = cls()
    t._pending = {"x": 1}       # unlocked access is just an attribute
    assert t._pending == {"x": 1}
    assert "_pending" in t.__dict__     # no mangled slot indirection


def test_rank_names_validated_even_when_off(monkeypatch):
    monkeypatch.delenv("SIDDHI_TPU_SANITIZE", raising=False)
    with pytest.raises(ValueError, match="undeclared lock rank"):
        @guarded
        class Bad:
            GUARDED_BY = {"_x": "nonsense"}


def _port_cluster_check(tmp_path) -> str:
    """The reference's ``tools/quick_cluster_check.py``, re-bound to the
    port on the CPU: the same apps, feed and exact comparisons."""
    with open(os.path.join(REPO, "tools", "quick_cluster_check.py")) as f:
        src = f.read()
    for old, new in (
            ("from siddhi_tpu import SiddhiManager, StreamCallback",
             "from siddhi_tpu_torch import SiddhiManager, StreamCallback"),
            ("from siddhi_tpu.cluster import ClusterRuntime",
             "from siddhi_tpu_torch.cluster import ClusterRuntime"),
            ("from siddhi_tpu.cluster.protocol import py_value",
             "from siddhi_tpu_torch.cluster.protocol import py_value"),
            ("m = SiddhiManager()", "m = SiddhiManager(device='cpu')"),
            ("ClusterRuntime(n_workers=2, heartbeat_s=0.2)",
             "ClusterRuntime(n_workers=2, heartbeat_s=0.2, device='cpu')")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert not re.search(r"\bsiddhi_tpu\b(?!_torch)", src.split('"""', 2)[2])
    path = tmp_path / "port_cluster_check.py"
    path.write_text(src)
    return str(path)


def test_quick_cluster_check_sanitized(tmp_path):
    """The port's multi-process tier under every sanitizer: the workers
    inherit ``SIDDHI_TPU_SANITIZE`` (``cluster/supervisor._child_env``), so
    the router, egress, supervisor and worker-side contracts are all
    enforced end to end."""
    env = dict(os.environ)
    env["SIDDHI_TPU_SANITIZE"] = "1"
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, _port_cluster_check(tmp_path)],
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "quick_cluster_check OK" in proc.stdout


# ================================================== against the reference

def test_ranks_and_edges_equal_the_reference():
    from siddhi_tpu.analysis import lockorder as ref

    assert list(lockorder.RANKS) == list(ref.RANKS)
    assert lockorder.EDGES == ref.EDGES
    assert lockorder.must_precede() == ref.must_precede()
    for rank, text in lockorder.RANKS.items():
        assert text == ref.RANKS[rank].replace("siddhi_tpu/", "siddhi_tpu_torch/")


def test_lock_order_messages_equal_the_reference():
    from siddhi_tpu.analysis.locks import CheckedRLock as RefLock
    from siddhi_tpu.analysis.locks import LockOrderError as RefError

    n = 0
    for held in lockorder.RANKS:
        for acq in lockorder.RANKS:
            if not lockorder.inversion(held, acq):
                continue
            with CheckedRLock(held), pytest.raises(LockOrderError) as got:
                CheckedRLock(acq).acquire()
            with RefLock(held), pytest.raises(RefError) as want:
                RefLock(acq).acquire()
            assert str(got.value).replace("siddhi_tpu_torch/", "siddhi_tpu/") \
                == str(want.value), (held, acq)
            n += 1
    assert n >= len(lockorder.EDGES)


def _source_ranks():
    """Every rank a ``make_lock`` call or a ``GUARDED_BY`` map in the
    port's source names."""
    ranks = set()
    for root, _dirs, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                src = f.read()
            ranks |= set(re.findall(r"make_lock\(\"(\w+)\"\)", src))
            for body in re.findall(r"GUARDED_BY = \{([^}]*)\}", src):
                ranks |= set(re.findall(r":\s*\"(\w+)\"", body))
    return ranks


def test_every_make_lock_rank_is_declared():
    ranks = _source_ranks()
    assert {"barrier", "owner", "pump", "ingest", "adapt", "wal", "shard",
            "overload", "app_supervisor", "autopilot", "link", "router",
            "egress", "cluster_ingest", "cluster_supervisor"} <= ranks
    assert ranks <= set(lockorder.RANKS), ranks - set(lockorder.RANKS)


GUARDED = [
    ("core.query.completion", "CompletionPump"),
    ("core.stream.input.pack_pool", "IngestPackPool"),
    ("core.stream.junction", "StreamJunction"),
]


@pytest.mark.parametrize("module,cls", GUARDED)
def test_guarded_classes_declare_the_reference_contract(module, cls):
    import importlib

    port = getattr(importlib.import_module(f"siddhi_tpu_torch.{module}"), cls)
    ref = getattr(importlib.import_module(f"siddhi_tpu.{module}"), cls)
    assert port.__dict__["GUARDED_BY"] == ref.__dict__["GUARDED_BY"]


_ARMED_ENGINE = """
import sys
sys.modules["jax"] = None
sys.modules["siddhi_tpu"] = None
import siddhi_tpu_torch
from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager, StreamCallback
from siddhi_tpu_torch.analysis import locks, sanitize
from siddhi_tpu_torch.analysis.guards import GuardViolation, _GuardedField
from siddhi_tpu_torch.analysis.locks import CheckedRLock
from siddhi_tpu_torch.core.query.completion import CompletionPump
from siddhi_tpu_torch.core.stream.input.pack_pool import IngestPackPool
from siddhi_tpu_torch.core.stream.junction import StreamJunction
import torch
for cls, fields in ((CompletionPump, ["_pending"]),
                    (IngestPackPool, ["_threads", "_gen"]),
                    (StreamJunction, ["_lat_ewma", "_cur_batch"])):
    assert all(isinstance(vars(cls)[f], _GuardedField) for f in fields), cls
try:
    float(torch.ones(1))
    raise SystemExit("the pull guard is not armed at import")
except sanitize.HostPullError:
    pass
class C(StreamCallback):
    def __init__(self): self.rows = []
    def receive(self, events): self.rows.extend(e.data for e in events)
m = SiddhiManager(device="cpu")
m.set_config_manager(InMemoryConfigManager({"siddhi_tpu.pipeline_depth": "4",
                                            "siddhi_tpu.ingest_pool": "2",
                                            "siddhi_tpu.ingest_split": "256"}))
rt = m.create_siddhi_app_runtime('''
@Async(buffer.size='8')
define stream S (sym string, v long);
@info(name = 'a') from S#window.length(4) select sym, sum(v) as t group by sym
insert into O;
@info(name = 'b') from S[v > 0] select sym, v insert into O2;''')
c, c2 = C(), C()
rt.add_callback("O", c); rt.add_callback("O2", c2)
import numpy as np
rt.get_input_handler("S").send_columns({"sym": np.array(["a", "b"] * 300, dtype=object),
                                        "v": np.arange(600, dtype=np.int64)})
sites = {"barrier": rt._barrier, "pump": rt.app_context.completion_pump._lock,
         "owner": rt.query_runtimes["a"]._lock,
         "ingest": rt.app_context.ingest_pack_pool._lock,
         "adapt": rt.junctions["S"]._adapt_lock}
if rt.fused_fanout_groups:
    sites["owner (fused)"] = rt.fused_fanout_groups[0]._lock
for rank, lk in sites.items():
    assert isinstance(lk, CheckedRLock) and lk.rank == rank.split()[0], (rank, lk)
pump = rt.app_context.completion_pump
try:
    pump._pending
    raise SystemExit("an unlocked read of the pump's FIFOs did not raise")
except GuardViolation:
    pass
m.shutdown()
assert len(c.rows) == 600 and c.rows[-1] == ["b", 597 + 599], c.rows[-1]
assert len(c2.rows) == 599 and locks.acquisitions() > 0
print("OK", len(rt.fused_fanout_groups))
"""


def test_an_armed_process_installs_every_contract_and_runs_clean():
    """``SIDDHI_TPU_SANITIZE=1`` at import: the pull guard is armed, the
    three guarded classes carry their descriptors, the six ranked sites
    are checked locks of the reference's ranks, an app through the pool
    and the pipeline at depth 4 runs clean, and an unlocked read of the
    pump's FIFOs raises."""
    env = dict(os.environ)
    env["SIDDHI_TPU_SANITIZE"] = "1"
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _ARMED_ENGINE],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)
    assert proc.returncode == 0 and proc.stdout.startswith("OK"), \
        proc.stdout + proc.stderr[-3000:]
    assert "Traceback" not in proc.stderr, proc.stderr[-3000:]


# ============================================================== the card

@pytest.mark.cuda
def test_cuda_planted_pull_raises_and_allowed_pull_does_not(sanitized):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pull is a device-to-host copy")
    t = torch.arange(4, device="cuda") * 3
    with pytest.raises(sanitize.HostPullError, match="cuda"):
        t[1].item()
    with sanitize.allowed_pull():
        assert t[1].item() == 3
    assert t.cpu().tolist() == [0, 3, 6, 9]


@pytest.mark.cuda
def test_cuda_recapture_after_freeze_names_the_key(sanitized):
    """A captured step replays its first spec silently after the freeze;
    a new column spec refuses its capture, naming the key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured as a CUDA graph")
    dev = torch.device("cuda")
    tel = _registry()
    state = {"acc": torch.zeros((), dtype=torch.float64, device=dev)}

    def fn(st, cols, now):
        st["acc"].add_(cols["x"].sum())
        return ({"y": cols["x"] * 2},), torch.stack([now, now])

    step = tel.instrument_jit(fn, "test.cuda_step", capturable=True)
    for _ in range(3):
        step.replay(state, {"x": np.ones(64)}, 1, 1)
    assert step.graph.captures == 1 and step.graph.replays == 2
    sanitize.freeze_compiles()
    try:
        step.replay(state, {"x": np.ones(64)}, 2, 1)
        with pytest.raises(sanitize.RecompileError, match="test.cuda_step"):
            step.replay(state, {"x": np.ones(128)}, 3, 1)
        assert step.graph.captures == 1
    finally:
        sanitize.thaw_compiles()
    torch.cuda.synchronize()
    with sanitize.allowed_pull():
        assert state["acc"].item() == 4 * 64
