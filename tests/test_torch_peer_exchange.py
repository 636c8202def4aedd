"""K8 across processes (``ops/exchange.peer_exchange_cols``), on the CPU.

- ``peer_plan``, the per-call segment plan the kernel executes, applied
  with torch copies across P = 2 and 4 in-process "processes" (one and
  two shards each, Q = 5 and 7 rows: not a multiple of 16, over 1-, 4-
  and 8-byte columns, ``torch_helpers.PEER_COLUMNS``): every destination
  segment written once, and each process's receive buffers equal to the
  one-process exchange of all n shards cut per process, exactly.
- The same plan against ``mesh._exchange`` in spawned gloo groups of 2 and
  of 4 processes (on ``127.0.0.1`` and a free port): every process's
  result under ``all_to_all`` (the group's collective) and under
  ``pallas_ring`` (whose plain version runs for CPU tensors) equals the
  plan's, exactly.
- The 2-process group routes the partitioned flagship under each
  exchange: every process's rows equal the other exchange's and the
  reference's single-process rows (floats to rtol 1e-12, the rest
  exact), and the kernel's counter stays 0 on the CPU.
- ``peer_schedule``, the writes and waits a call puts on its stream,
  driven through a model of P = 2, 3 and 4 processes over 6 steps that
  applies its writes and treats its waits as "at least" predicates: every
  reachable interleaving is explored (a state is the processes' positions
  in their programs), and none deadlocks, lets a reader see a half before every writer's
  kernel of the step, or lets a writer start on a half before every
  reader's reads of it are done. A schedule with one generation shifted
  by one fails the same model. ``_sync`` turns the schedule into words of
  the right pages, unchanged.
- On the card (``cuda`` marker; skips here): two processes on ``cuda:0``
  over gloo, the kernel's receive buffers equal the plain path's bit for
  bit, one launch a routed dispatch, and the routed rows equal
  ``all_to_all``'s; 8 consecutive calls with changing data through both
  halves == the plain path bit for bit, with no ``torch.distributed`` call
  after the first; a peer that sleeps 0.5 s does not hold the other's
  host in its call; a peer that exits mid-run gives the survivor
  ``ClusterPeerError`` within the step's bound, and its
  ``torch.cuda.synchronize()`` and ``close()`` then return.

The children import ``siddhi_tpu_torch`` only and assert at their end
that neither ``jax`` nor ``siddhi_tpu`` was imported. Run alone:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_peer_exchange.py``.
"""

import ctypes
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_helpers import (
    PARTITIONED_APP,
    assert_rows_match,
    peer_sends,
    release_jax_programs,  # noqa: F401 — autouse fixture: frees JAX programs
    send_feed,
    stock_feed,
)

from siddhi_tpu_torch.ops import exchange as ex
from siddhi_tpu_torch.ops.exchange import peer_plan, peer_schedule, ring_exchange_plain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

CASES = [(L, Q) for L in (1, 2) for Q in (5, 7)]
STOCK = dict(seed=1, n_batches=4, batch=256, n_symbols=100, n_events=8)

WORKER = textwrap.dedent('''
    import os
    import pickle
    import sys

    root, port, P, rank, out, device, cases, stock = sys.argv[1:9]
    P, rank = int(P), int(rank)
    cases, stock = eval(cases), eval(stock)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    torch.set_num_threads(1)
    from siddhi_tpu_torch.parallel import distributed

    dev = torch.device(device if device == "cpu" else "cuda:0")
    distributed.initialize_cluster(f"127.0.0.1:{port}", P, rank, backend="gloo",
                                   device=dev)
    import siddhi_tpu_torch
    import torch_helpers
    from siddhi_tpu_torch.ops.exchange import peer_exchange_cols
    from siddhi_tpu_torch.parallel.mesh import (
        RouteLayout, _exchange, device_route_query_step)

    res = {"exchange": {}, "rows": {}}
    for L, Q in cases:
        sent = [t.to(dev) for t in torch_helpers.peer_sends(P, L, Q, rank)]
        for exch in ("all_to_all", "pallas_ring"):
            layout = RouteLayout(distributed.global_mesh(L, dev), 256, exch, False,
                                 False, dev)
            got = _exchange(layout, sent, 60.0)
            res["exchange"][(L, Q, exch)] = [g.cpu().numpy().copy() for g in got]
            layout.close_peer(60.0)
    if P == 2:
        for exch in ("all_to_all", "pallas_ring"):
            peer_exchange_cols.launches = 0
            m = siddhi_tpu_torch.SiddhiManager(device=dev)
            rt = m.create_siddhi_app_runtime(torch_helpers.PARTITIONED_APP.format(W=8))
            c = torch_helpers.make_collector(siddhi_tpu_torch.StreamCallback)
            rt.add_callback("OutStream", c)
            q = rt.query_runtimes["bench"]
            device_route_query_step(q, distributed.global_mesh(2), rows_per_shard=256,
                                    exchange=exch)
            torch_helpers.send_feed(rt, "StockStream", torch_helpers.stock_feed(**stock))
            res["rows"][exch] = (c.rows, q._route_layout.dispatches,
                                 peer_exchange_cols.launches)
            m.shutdown()
    bad = [k for k in sys.modules if k in ("jax", "siddhi_tpu")
           or k.startswith(("jax.", "siddhi_tpu."))]
    assert not bad, bad
    res["imports_clean"] = True
    distributed.shutdown_cluster()
    with open(out, "wb") as f:
        pickle.dump(res, f)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Group:
    """One gloo group of ``P`` processes on ``device`` running the worker:
    spawned by the first test process of the session to need it (a shared
    owner file), whose results every test process reads."""

    def __init__(self, root: Path, P: int, device: str, script: str = WORKER,
                 scenario: str = ""):
        tag = f"peer{P}_{device}{scenario}"
        self.outs = [root / f"{tag}_{r}.pkl" for r in range(P)]
        self.logs = [root / f"{tag}_{r}.log" for r in range(P)]
        self.done = root / f"{tag}.done"
        self.procs = []
        self._res = None
        try:
            os.close(os.open(root / f"{tag}.owner", os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            return          # another test process spawned it
        port = _free_port()
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        for r in range(P):
            with open(self.logs[r], "w") as log:
                args = ([str(ROOT), str(port), str(P), str(r), str(self.outs[r])]
                        + ([scenario] if script is not WORKER
                           else [device, repr(CASES), repr(STOCK)]))
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", script, *args],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(root)))

    def results(self):
        if self._res is None:
            if self.procs:
                for p in self.procs:
                    try:
                        p.wait(timeout=240)
                    except subprocess.TimeoutExpired:
                        p.kill()
                self.done.touch()
            else:
                deadline = time.time() + 300
                while not self.done.exists():
                    assert time.time() < deadline, "the spawning process never finished"
                    time.sleep(0.2)
            self._res = {r: (pickle.loads(out.read_bytes()) if out.exists()
                             else log.read_text()[-3000:])
                         for r, (out, log) in enumerate(zip(self.outs, self.logs))}
        for r, v in self._res.items():
            assert isinstance(v, dict), f"process {r} failed:\n{v}"
            assert v["imports_clean"], r
        return self._res

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()


def _shared_dir(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "gloo_peer"
    root.mkdir(exist_ok=True)
    return root


@pytest.fixture(scope="session")
def cpu_groups(tmp_path_factory):
    root = _shared_dir(tmp_path_factory)
    groups = {P: _Group(root, P, "cpu") for P in (2, 4)}
    yield groups
    for g in groups.values():
        g.stop()


def _apply_plan(P, L, Q):
    """Every process's send buffers moved by ``peer_plan`` with torch
    copies; returns each process's receive buffers and the (process,
    segment) pairs written."""
    n = P * L
    sends = [peer_sends(P, L, Q, p) for p in range(P)]
    recv = [[torch.zeros_like(t) for t in sends[0]] for _ in range(P)]
    written = []
    for p in range(P):
        for pair, (q, seg) in enumerate(peer_plan(n, L, p)):
            written.append((q, seg))
            for src, dst in zip(sends[p], recv[q]):
                tail = tuple(src.shape[2:])
                dst.view((L * n, Q) + tail)[seg] = src.view((L * n, Q) + tail)[pair]
    return sends, recv, written


@pytest.mark.parametrize("P,L,Q", [(P, L, Q) for P in (2, 4) for L, Q in CASES])
def test_plan_moves_every_segment_to_its_owner(P, L, Q):
    n = P * L
    sends, recv, written = _apply_plan(P, L, Q)
    assert sorted(written) == [(q, seg) for q in range(P) for seg in range(L * n)]
    for i in range(len(sends[0])):
        whole = ring_exchange_plain(torch.cat([s[i] for s in sends]), n)
        for q in range(P):
            assert torch.equal(recv[q][i], whole[q * L:(q + 1) * L]), (i, q)


@pytest.mark.parametrize("P", [2, 4])
def test_plan_equals_the_exchange_across_processes(cpu_groups, P):
    res = cpu_groups[P].results()
    for L, Q in CASES:
        _sends, recv, _ = _apply_plan(P, L, Q)
        for q in range(P):
            for exch in ("all_to_all", "pallas_ring"):
                got = res[q]["exchange"][(L, Q, exch)]
                assert len(got) == len(recv[q])
                for i, (g, want) in enumerate(zip(got, recv[q])):
                    np.testing.assert_array_equal(g, want.numpy(),
                                                  err_msg=f"{(L, Q, exch, q, i)}")


def _reference_rows():
    import siddhi_tpu
    from torch_helpers import make_collector

    m = siddhi_tpu.SiddhiManager()
    rt = m.create_siddhi_app_runtime(PARTITIONED_APP.format(W=8))
    c = make_collector(siddhi_tpu.StreamCallback)
    rt.add_callback("OutStream", c)
    send_feed(rt, "StockStream", stock_feed(**STOCK))
    m.shutdown()
    return c.rows


def test_pallas_ring_rows_across_processes_equal_all_to_all_and_the_reference(cpu_groups):
    want = _reference_rows()
    assert want
    for r, res in cpu_groups[2].results().items():
        rows, dispatches, launches = res["rows"]["pallas_ring"]
        assert dispatches >= STOCK["n_batches"] and launches == 0, (r, dispatches, launches)
        assert_rows_match(rows, want)
        assert_rows_match(res["rows"]["all_to_all"][0], want)


@pytest.mark.cuda
def test_peer_kernel_on_the_card_equals_the_plain_path(tmp_path):
    """Two processes on ``cuda:0`` over gloo: the kernel's receive buffers
    == the plain path's (``ring_exchange_cols`` plus ``all_to_all_cols``),
    bit for bit, at every case; the routed flagship launches the kernel
    once a dispatch and its rows == ``all_to_all``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the peer exchange is CUDA C++ over CUDA "
                    "IPC, with no CPU mode")
    group = _Group(tmp_path, 2, "cuda")
    try:
        res = group.results()
    finally:
        group.stop()
    for r, out in res.items():
        for L, Q in CASES:
            for i, (k, plain) in enumerate(zip(out["exchange"][(L, Q, "pallas_ring")],
                                               out["exchange"][(L, Q, "all_to_all")])):
                assert k.dtype == plain.dtype and k.tobytes() == plain.tobytes(), (r, L, Q, i)
        rows, dispatches, launches = out["rows"]["pallas_ring"]
        assert launches == dispatches >= STOCK["n_batches"], (r, launches, dispatches)
        assert_rows_match(rows, out["rows"]["all_to_all"][0])


# ------------------------------------------- the completion schedule, modelled

STEPS = 6


def _program(P, p, schedule):
    """Process ``p``'s actions over ``STEPS`` calls: its kernel's start and
    end, each of the schedule's writes and waits, then its reads' start
    and end (before its next call)."""
    prog = []
    for k in range(STEPS):
        prog += [("kernel_start", k), ("kernel_end", k)]
        prog += [(op.kind, op) for op in schedule(k, P, p)]
        prog += [("read_start", k), ("read_end", k)]
    return prog


def _check_schedule(P, schedule):
    """Explore every interleaving of ``P`` processes running ``schedule``:
    a state is the tuple of their positions in their programs (every
    word, half and read is a function of its one writer's position).
    Returns the number of states; raises AssertionError naming the first
    deadlock, stale read or early overwrite."""
    progs = [_program(P, p, schedule) for p in range(P)]
    for p, prog in enumerate(progs):
        for kind, op in prog:
            if kind == "wait":
                assert op.owner == p, op        # its own header only
            if kind == "write":
                assert op.index == p, op        # its own word only

    def word(owner, index, pc):
        # ``written[index]`` of ``owner``'s header once ``index`` ran its
        # first ``pc`` actions
        v = 0
        for kind, op in progs[index][:pc]:
            if kind == "write" and op.owner == owner:
                assert op.value >= v, f"written[{index}] of {owner} shrinks"
                v = op.value
        return v

    def tag(owner, half, writer, pc):
        # the step whose kernel last finished writing ``writer``'s share
        # of ``half`` of ``owner``'s arena
        t = None
        for kind, k in progs[writer][:pc]:
            if kind == "kernel_end" and k % 2 == half:
                t = k
        return t

    def read_done(q, k, pc):
        return ("read_end", k) in progs[q][:pc]

    seen, todo = set(), [tuple([0] * P)]
    while todo:
        state = todo.pop()
        if state in seen:
            continue
        seen.add(state)
        moved = False
        for p in range(P):
            pc = state[p]
            if pc == len(progs[p]):
                continue
            kind, arg = progs[p][pc]
            if kind == "wait" and word(p, arg.index, state[arg.index]) < arg.value:
                continue
            if kind == "kernel_start" and arg >= 2:
                for q in range(P):
                    assert read_done(q, arg - 2, state[q]), (
                        f"process {p} starts writing half {arg % 2} at step {arg} "
                        f"before process {q} read it at step {arg - 2}: {state}")
            if kind in ("read_start", "read_end"):
                for w in range(P):
                    t = tag(p, arg % 2, w, state[w])
                    assert t == arg, (
                        f"process {p} reads half {arg % 2} at step {arg} holding "
                        f"process {w}'s step {t}: {state}")
            nxt = list(state)
            nxt[p] += 1
            todo.append(tuple(nxt))
            moved = True
        assert moved or all(state[p] == len(progs[p]) for p in range(P)), (
            f"deadlock at {state}")
    return len(seen)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_schedule_holds_in_every_interleaving(P):
    states = _check_schedule(P, peer_schedule)
    assert states > STEPS * P


def _shifted(kind, by):
    """``peer_schedule`` with one generation moved by ``by``: its ``kind``
    ops'."""
    def schedule(step, P, p):
        return [op._replace(value=op.value + by) if op.kind == kind else op
                for op in peer_schedule(step, P, p)]
    return schedule


@pytest.mark.parametrize("kind,by", [("wait", -1), ("write", 1)])
def test_a_shifted_generation_fails_the_model(kind, by):
    with pytest.raises(AssertionError, match="reads half|starts writing"):
        _check_schedule(2, _shifted(kind, by))


def test_sync_puts_the_schedule_on_the_pages_words():
    """``PeerExchange._sync`` gives the C entry exactly the schedule's ops,
    each at its owner's page of words plus the word's offset, the waits
    with the card's flush flag; the last writes the process's own word."""
    P, p = 3, 1
    peer = ex.PeerExchange(3, 1, P, p)
    arena = ex._Arena([], [], 0)
    arena.words = [0x1000_0000 * (q + 1) for q in range(P)]
    got = []

    class Lib:
        def siddhi_stream_sync(self, table, n, stream):
            got.append([(t.addr, t.value, t.wait, t.flush) for t in table[:n]])
            return 0

    peer._res["lib"], peer._flush = Lib(), True
    for k in range(4):
        ops = peer_schedule(k, P, p)
        peer._sync(arena, ops, 0)
        want = [(arena.words[op.owner] + ex.word_offset(op.index), op.value,
                 int(op.kind == "wait"), int(op.kind == "wait")) for op in ops]
        assert got.pop() == want
        assert [op.value for op in ops] == [k + 1] * (2 * P - 1)
        assert ops[-1] == ex.SyncOp("write", p, p, k + 1)
    assert not got


class _Fired:
    def __init__(self):
        self.n = 0

    def fire(self):
        self.n += 1


@pytest.mark.parametrize("arrives", [True, False])
def test_watchdog_fires_once_for_a_word_short_at_its_deadline(arrives):
    """The watchdog drops a call whose word reached its value, and fires
    once, then stops, for one still short at its deadline; the hand-over
    is a plain ``watch`` call (no CUDA)."""
    words = (ctypes.c_ulonglong * 2)()
    fired = _Fired()
    dog = ex._Watchdog(fired.fire)
    try:
        dog.watch(words, 1, 1, 0.3)
        if arrives:
            words[1] = 1
        time.sleep(0.3 + 6 * ex.WATCH_TICK_S)
        assert fired.n == (0 if arrives else 1)
        assert dog._thread.is_alive() == arrives
    finally:
        dog.stop()
    assert not dog._thread.is_alive() and fired.n == (0 if arrives else 1)


# ------------------------------------------------ the completion on the card

CARD_WORKER = textwrap.dedent('''
    import os
    import pickle
    import sys
    import time

    root, port, P, rank, out, scenario = sys.argv[1:7]
    P, rank = int(P), int(rank)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch
    import torch.distributed as dist

    from siddhi_tpu_torch.parallel import distributed

    dev = torch.device("cuda", 0)
    distributed.initialize_cluster(f"127.0.0.1:{port}", P, rank, backend="gloo",
                                   device=dev)
    import torch_helpers
    from siddhi_tpu_torch.ops import exchange as ex

    calls = {"n": 0}
    for name in ("all_reduce", "all_gather", "all_gather_object", "all_to_all",
                 "all_to_all_single", "barrier", "broadcast", "reduce", "gather",
                 "scatter", "send", "recv", "isend", "irecv", "reduce_scatter",
                 "all_gather_into_tensor", "reduce_scatter_tensor", "new_group"):
        fn = getattr(dist, name, None)
        if fn is not None:
            def counted(*a, _fn=fn, **k):
                calls["n"] += 1
                return _fn(*a, **k)
            setattr(dist, name, counted)

    def sends(L, Q, i):
        # the seeded buffers rolled by the call: new data every call
        return [torch.roll(t, i, 1).contiguous().to(dev)
                for t in torch_helpers.peer_sends(P, L, Q, rank)]

    def same(a, b):
        return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.contiguous().view(-1).view(torch.uint8),
            y.contiguous().view(-1).view(torch.uint8)) for x, y in zip(a, b))

    res = {"scenario": scenario}
    if scenario == "calls":
        res["cases"] = {}
        for L, Q in ((1, 5), (2, 7)):
            peer = ex.PeerExchange(P * L, L, P, rank)
            ex.peer_exchange_cols.launches = 0
            equal, dist_calls, halves = [], [], []
            for i in range(8):
                sent = sends(L, Q, i)
                n0 = calls["n"]
                got = ex.peer_exchange_cols(sent, peer, 60.0, "card test")
                dist_calls.append(calls["n"] - n0)
                halves.append(got[0].data_ptr())
                got = [g.clone() for g in got]
                plain = ex.process_exchange_plain(sent, P * L, L, rank, 60.0, "plain")
                equal.append(same(got, plain))
            res["cases"][(L, Q)] = {"equal": equal, "dist_calls": dist_calls,
                                    "halves": len(set(halves)),
                                    "launches": ex.peer_exchange_cols.launches}
            peer.close(60.0)
    elif scenario == "sleep":
        peer = ex.PeerExchange(2 * P, 2, P, rank)
        res["call_s"], res["sync_s"], res["equal"] = [], [], []
        for i in range(3):
            sent = sends(2, 5, i)
            torch.cuda.synchronize()
            if rank == 1 and i:
                time.sleep(0.5)
            t0 = time.perf_counter()
            got = ex.peer_exchange_cols(sent, peer, 60.0, "card test")
            res["call_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            res["sync_s"].append(time.perf_counter() - t0)
            got = [g.clone() for g in got]
            plain = ex.process_exchange_plain(sent, 2 * P, 2, rank, 60.0, "plain")
            res["equal"].append(same(got, plain))
        peer.close(60.0)
    elif scenario.startswith("kill"):
        from siddhi_tpu_torch.parallel.distributed import ClusterPeerError

        timeout, before = 3.0, int(scenario[4:])
        peer = ex.PeerExchange(2 * P, 2, P, rank)
        for i in range(before):
            got = ex.peer_exchange_cols(sends(2, 5, i), peer, timeout, "card test")
            ex.all_gather_same([got[0].sum()], timeout, "card test egress")
        torch.cuda.synchronize()
        if rank == 1:
            res["imports_clean"] = True
            with open(out, "wb") as f:
                pickle.dump(res, f)
            os._exit(0)     # mid-run: the survivor's next call finds no peer
        t0 = time.perf_counter()
        got = ex.peer_exchange_cols(sends(2, 5, before), peer, timeout, "card test")
        res["call_s"] = time.perf_counter() - t0
        try:
            ex.all_gather_same([got[0].sum()], timeout, "card test egress")
            res["raised"] = None
        except ClusterPeerError as e:
            res["raised"] = str(e)[:300]
        res["raise_s"] = time.perf_counter() - t0
        res["timeout"] = timeout
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        res["sync_s"] = time.perf_counter() - t0
        # the segments process 1's sources (global shards 2, 3) would have
        # written into this call's half
        res["unwritten"] = [g.reshape(2, 2 * P, -1)[:, 2:4].contiguous().view(-1)
                            .view(torch.uint8).cpu() for g in got]
        try:
            ex.peer_exchange_cols(sends(2, 5, before + 1), peer, timeout, "card test")
            res["after"] = None
        except ClusterPeerError as e:
            res["after"] = str(e)[:300]
        t0 = time.perf_counter()
        peer.close(timeout)
        res["close_s"] = time.perf_counter() - t0
        res["imports_clean"] = True
        with open(out, "wb") as f:
            pickle.dump(res, f)
        os._exit(0)         # the group's peer is gone: no teardown
    bad = [k for k in sys.modules if k in ("jax", "siddhi_tpu")
           or k.startswith(("jax.", "siddhi_tpu."))]
    assert not bad, bad
    res["imports_clean"] = True
    distributed.shutdown_cluster()
    with open(out, "wb") as f:
        pickle.dump(res, f)
''')


def _card_group(tmp_path, scenario):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the peer exchange is CUDA C++ over CUDA "
                    "IPC, with no CPU mode")
    group = _Group(tmp_path, 2, "cuda", CARD_WORKER, scenario)
    try:
        return group.results()
    finally:
        group.stop()


@pytest.mark.cuda
def test_peer_consecutive_calls_on_the_card_equal_the_plain_path(tmp_path):
    """8 calls a case with new data each, through both halves: every
    receive buffer == ``process_exchange_plain``'s bit for bit; one launch
    a call; no ``torch.distributed`` call but at the first (the arena's
    one-off trade and barrier)."""
    for r, out in _card_group(tmp_path, "calls").items():
        for case, c in out["cases"].items():
            assert all(c["equal"]), (r, case, c["equal"])
            assert c["halves"] == 2 and c["launches"] == 8, (r, case, c)
            assert c["dist_calls"][0] > 0 and not any(c["dist_calls"][1:]), (r, case, c)


@pytest.mark.cuda
def test_a_sleeping_peer_does_not_hold_the_host_in_the_call(tmp_path):
    """Process 1 sleeps 0.5 s before calls 1 and 2: process 0's calls
    return at once (the wait is on its stream), its sync then takes the
    sleep, and every result == the plain path's."""
    res = _card_group(tmp_path, "sleep")
    for r, out in res.items():
        assert all(out["equal"]), (r, out)
    zero = res[0]
    assert max(zero["call_s"][1:]) < 0.1, zero
    assert min(zero["sync_s"][1:]) > 0.3, zero


@pytest.mark.cuda
@pytest.mark.parametrize("before", [1, 3])
def test_a_dead_peer_raises_and_the_survivor_drains(tmp_path, before):
    """Process 1 exits after ``before`` calls: process 0's next call
    returns at once, the bounded gather after it raises
    ``ClusterPeerError`` within the bound + 5 s, then its
    ``torch.cuda.synchronize()`` and ``close()`` return and a later call
    raises at once. After 1 call the survivor's call reads a half the
    peer never wrote: its segments there read as zeros (the arena is
    zeroed when it is allocated), not as what the allocation held."""
    out = _card_group(tmp_path, f"kill{before}")[0]
    assert out["call_s"] < 0.1, out
    assert out["raised"] and out["raise_s"] < out["timeout"] + 5.0, out
    assert out["after"] and "failed" in out["after"], out
    assert out["sync_s"] < 5.0 and out["close_s"] < 5.0, out
    if before == 1:
        assert all(not u.any() for u in out["unwritten"]), out["unwritten"]
