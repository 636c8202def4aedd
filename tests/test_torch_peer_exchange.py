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
- On the card (``cuda`` marker; skips here): two processes on ``cuda:0``
  over gloo, the kernel's receive buffers equal the plain path's bit for
  bit, one launch a routed dispatch, and the routed rows equal
  ``all_to_all``'s.

The children import ``siddhi_tpu_torch`` only and assert at their end
that neither ``jax`` nor ``siddhi_tpu`` was imported. Run alone:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_peer_exchange.py``.
"""

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

from siddhi_tpu_torch.ops.exchange import peer_plan, ring_exchange_plain

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

    def __init__(self, root: Path, P: int, device: str):
        tag = f"peer{P}_{device}"
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
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(ROOT), str(port), str(P), str(r),
                     str(self.outs[r]), device, repr(CASES), repr(STOCK)],
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
