"""The shard exchange of the device-routed step: ``ring_exchange_cols``.

Counterpart of ``siddhi_tpu/parallel/mesh.py:1242`` (``_pallas_ring_exchange``,
the repo's one Pallas TPU kernel) and of the ``lax.all_to_all(tiled=True)``
it stands for. On one card the n logical shards' send buffers of a column
are rows of one ``[n, n*Q, *tail]`` tensor, and

    out[d, s*Q:(s+1)*Q] = buf[s, d*Q:(d+1)*Q]

i.e. segment d of shard s goes to shard d, and rows arrive source-major.

``ring_exchange_cols(bufs, n)`` exchanges every column of a routed batch
(any mix of dtypes, Qs and tails) with one launch of the hand-written CUDA
kernel (``csrc/ring_exchange.cu``) per ``MAX_COLS`` columns, into outputs
that are views of one byte arena. It uses the plain version only for CPU
tensors; there is no fallback for a CUDA tensor. ``ring_exchange(buf, n)``
is the one-buffer form. ``ring_exchange.launches`` counts kernel launches
and ``ring_exchange.columns`` the columns they moved.

Across processes (``parallel/distributed.py``) process p holds L of the
n shards, and its send buffers are ``[L, n*Q, *tail]``. Two exchanges:

- ``process_exchange_plain``: the pairs between the process's own shards
  take ``ring_exchange_cols``, and the rows bound for another process's
  shards travel in ``all_to_all_cols``: every column's blocks packed into
  one byte buffer and moved by ONE ``torch.distributed.all_to_all_single``
  (the counterpart of the reference's ``lax.all_to_all`` between hosts).
- ``peer_exchange_cols``: K8 itself across processes, the CUDA form of the
  TPU kernel's ``make_async_remote_copy``. Every process maps every other
  process's receive arena through CUDA IPC (``PeerExchange``), and one
  launch of the kernel writes each (local source, global destination)
  segment of every column straight into its owner's arena, at the offset
  ``peer_plan`` gives. Processes on one host whose cards reach each other
  (one card, or cards with peer access). Completion is on 64-bit
  generation words in shared host memory, written and awaited by the
  card's stream memory operations in the order ``peer_schedule`` gives:
  no host barrier and no interprocess event. Its plain version, for CPU
  tensors, is ``process_exchange_plain``; on a card nothing falls back.

``all_gather_rows`` is the egress: one ``all_gather`` of every process's
emitted rows, padded to the longest. The collectives are the process
group's, NCCL between cards and gloo between CPU processes.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import math
import queue
import threading
import time
import weakref
import zlib
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from siddhi_tpu_torch.ops import _cuda

MAX_COLS = 64          # columns one launch takes (the kernel's table size)
ARENA_ALIGN = 128      # byte alignment of every output in the arena
# the cross-process entry's table (csrc/ring_exchange.cu PeerTable)
MAX_PEER_COLS = 32
MAX_PEER_PROCS = 16
MAX_PEER_PAIRS = 512
IPC_HANDLE_BYTES = 64  # cudaIpcMemHandle_t
RELEASED = 1 << 62     # a released generation word: every wait on it is met
WATCH_TICK_S = 0.05    # the watchdog's polling period


class _ExchangeCol(ctypes.Structure):
    """One column of the kernel's table (``ExchangeCol`` in the source)."""

    _fields_ = [("inp", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("seg_bytes", ctypes.c_longlong)]


class _PeerCol(ctypes.Structure):
    """One column of the cross-process table (``PeerCol`` in the source)."""

    _fields_ = [("inp", ctypes.c_void_p), ("out_off", ctypes.c_longlong),
                ("seg_bytes", ctypes.c_longlong)]


class _PeerSync(ctypes.Structure):
    """One stream memory operation (``PeerSync`` in the source)."""

    _fields_ = [("addr", ctypes.c_ulonglong), ("value", ctypes.c_ulonglong),
                ("wait", ctypes.c_int), ("flush", ctypes.c_int)]


def _check_cols(bufs: Sequence[torch.Tensor], n: int) -> None:
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"ring_exchange: n must be a positive int, got {n!r}")
    for buf in bufs:
        if buf.dim() < 2 or buf.shape[0] != n:
            raise ValueError(
                f"ring_exchange: buf must be [n, n*Q, ...] with n={n}, got "
                f"{tuple(buf.shape)}")
        if buf.shape[1] % n:
            raise ValueError(
                f"ring_exchange: buf.shape[1]={buf.shape[1]} is not a multiple "
                f"of n={n}")
        if not buf.is_contiguous():
            raise ValueError("ring_exchange: buf must be contiguous")
        if buf.device != bufs[0].device:
            raise ValueError(
                f"ring_exchange: buffers on {bufs[0].device} and {buf.device}")


def _declare(fn, *argtypes) -> None:
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)


def _bind(lib) -> None:
    # every pointer and the stream as c_void_p: a plain int would be cut
    # to 32 bits
    vp, i32, ptr = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER
    i64, u64 = ctypes.c_longlong, ctypes.c_ulonglong
    _declare(lib.siddhi_ring_exchange_cols, ptr(_ExchangeCol), i32, i64, vp)
    _declare(lib.siddhi_peer_exchange_cols, ptr(_PeerCol), i32, ptr(u64), i32,
             ptr(ctypes.c_uint), i32, vp)
    _declare(lib.siddhi_ipc_alloc, i64, ptr(vp), ctypes.c_char_p)
    _declare(lib.siddhi_ipc_free, vp)
    _declare(lib.siddhi_ipc_open, ctypes.c_char_p, ptr(vp))
    _declare(lib.siddhi_ipc_close, vp)
    _declare(lib.siddhi_words_create, ptr(i32), ptr(vp), ptr(u64))
    _declare(lib.siddhi_words_open, i32, i32, ptr(vp), ptr(u64))
    _declare(lib.siddhi_words_close, vp)
    _declare(lib.siddhi_fd_close, i32)
    _declare(lib.siddhi_stream_memops, ptr(i32), ptr(i32))
    _declare(lib.siddhi_stream_sync, ptr(_PeerSync), i32, vp)


def arena_layout(specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]]):
    """Byte offsets of contiguous tensors of the given (shape, dtype)s laid
    end to end, each at a multiple of ``ARENA_ALIGN``, and the bytes they
    span."""
    offsets, end = [], 0
    for shape, dtype in specs:
        start = -(-end // ARENA_ALIGN) * ARENA_ALIGN
        offsets.append(start)
        end = start + math.prod(shape) * dtype.itemsize
    return offsets, end


def _views(storage, base: int, specs, offsets, device) -> List[torch.Tensor]:
    # one set_ per output (a slice and two views cost three ops each)
    return [torch.empty(0, dtype=dtype, device=device).set_(
                storage, (base + off) // dtype.itemsize, shape)
            for (shape, dtype), off in zip(specs, offsets)]


def arena_views(specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                device) -> List[torch.Tensor]:
    """Contiguous tensors of the given (shape, dtype)s as views of ONE
    ``torch.empty`` byte arena on ``device``, each starting at a multiple
    of ``ARENA_ALIGN`` bytes (one allocation; aligned starts for the
    kernel's bulk copies)."""
    offsets, end = arena_layout(specs)
    arena = torch.empty(end + ARENA_ALIGN, dtype=torch.uint8, device=device)
    base = -arena.data_ptr() % ARENA_ALIGN
    return _views(arena.untyped_storage(), base, specs, offsets, device)


def ring_exchange_plain(buf: torch.Tensor, n: int) -> torch.Tensor:
    """The exchange of one buffer in plain torch ops (the kernel's
    reference)."""
    _check_cols([buf], n)
    Q = buf.shape[1] // n
    tail = tuple(buf.shape[2:])
    return buf.view(n, n, Q, *tail).transpose(0, 1).reshape(n, n * Q, *tail)


def ring_exchange_cols_plain(bufs: Sequence[torch.Tensor], n: int) -> List[torch.Tensor]:
    """The exchange of every buffer in plain torch ops."""
    return [ring_exchange_plain(b, n) for b in bufs]


def ring_exchange_cols(bufs: Sequence[torch.Tensor], n: int) -> List[torch.Tensor]:
    """Exchange segments between n co-resident shards for every buffer
    (see module doc); returns the exchanged tensors in order."""
    bufs = list(bufs)
    _check_cols(bufs, n)
    if not bufs:
        return []
    device = bufs[0].device
    if device.type == "cpu":
        return ring_exchange_cols_plain(bufs, n)
    if device.type != "cuda":
        raise ValueError(f"ring_exchange: unsupported device {device}")
    lib = _cuda.load("ring_exchange", _bind)
    outs = arena_views([(b.shape, b.dtype) for b in bufs], device)
    seg = [b.numel() // (n * n) * b.element_size() for b in bufs]
    # the stream and the launch belong to the buffers' card
    guard = (torch.cuda.device(device) if device.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo in range(0, len(bufs), MAX_COLS):
            part = range(lo, min(lo + MAX_COLS, len(bufs)))
            if not any(seg[i] for i in part):
                continue            # nothing to move: no launch
            table = (_ExchangeCol * len(part))(
                *[_ExchangeCol(bufs[i].data_ptr(), outs[i].data_ptr(), seg[i])
                  for i in part])
            code = lib.siddhi_ring_exchange_cols(table, len(part), n, stream)
            _cuda.check(lib, code, "ring_exchange launch")
            _cuda.count(ring_exchange)
            _cuda.count(ring_exchange, "columns", len(part))
    return outs


def ring_exchange(buf: torch.Tensor, n: int) -> torch.Tensor:
    """Exchange one buffer (the signature the multi-card exchange keeps)."""
    return ring_exchange_cols([buf], n)[0]


ring_exchange.launches = 0
ring_exchange.columns = 0


# ------------------------------------------------------ across processes

_PACK_ALIGN = 8        # bytes: every packed segment starts 8-aligned


def _finish(work, timeout_s, what: str) -> None:
    """Wait for a collective of the process group, bounded by
    ``timeout_s`` (the app's ``siddhi_tpu.cluster_step_timeout``) when
    set; a failure or a timeout means a peer process is presumed dead and
    raises ``ClusterPeerError`` (terminal for the runtime: the group is
    left mid-collective)."""
    import datetime

    import torch.distributed as dist

    try:
        if timeout_s is None:
            work.wait()
        else:
            work.wait(datetime.timedelta(seconds=float(timeout_s)))
    except Exception as ex:  # noqa: BLE001 — every failure of a collective
        from siddhi_tpu_torch.parallel.distributed import ClusterPeerError

        raise ClusterPeerError(
            f"{what}: the {dist.get_world_size()}-process group's collective "
            f"failed in process {dist.get_rank()} — a cluster peer process is "
            f"presumed dead ({type(ex).__name__}: {ex}); this error is "
            f"terminal for the runtime: abandon it, restart the cluster and "
            f"restore from the last snapshot revision") from ex


def _byte_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` as a ``[rows, bytes]`` uint8 view (contiguous)."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.reshape(rows, math.prod(t.shape[1:])).view(torch.uint8)


def _pack_rows(tensors: Sequence[torch.Tensor], rows: int):
    """Every tensor (leading dim ``rows``) packed side by side into one
    ``[rows, width]`` uint8 buffer; returns it and the segment offsets."""
    parts, offs, width = [], [], 0
    for t in tensors:
        b = _byte_rows(t, rows)
        offs.append(width)
        pad = -b.shape[1] % _PACK_ALIGN
        parts.append(b)
        if pad:
            parts.append(torch.zeros((rows, pad), dtype=torch.uint8, device=b.device))
        width += b.shape[1] + pad
    if not parts:
        return torch.zeros((rows, 0), dtype=torch.uint8), offs
    return torch.cat(parts, dim=1), offs


def _unpack_rows(buf: torch.Tensor, offs, like: Sequence[torch.Tensor],
                 shapes) -> List[torch.Tensor]:
    """The inverse of ``_pack_rows`` for buffers whose rows are ``shapes``."""
    out = []
    for t, off, shape in zip(like, offs, shapes):
        nb = math.prod(shape[1:]) * t.element_size() if len(shape) > 1 else t.element_size()
        seg = buf[:, off:off + nb].contiguous()
        dt = torch.uint8 if t.dtype == torch.bool else t.dtype
        v = seg.view(dt).reshape(shape)
        out.append(v.view(torch.bool) if t.dtype == torch.bool else v)
    return out


def all_to_all_cols(blocks: Sequence[torch.Tensor], timeout_s=None,
                    what: str = "shard exchange") -> List[torch.Tensor]:
    """Exchange per-process blocks of every column across the process
    group: ``blocks[i]`` is ``[P, *rest]`` with block q bound for process
    q; the result's block q came from process q. Every column's blocks
    travel packed in one ``all_to_all_single`` of equal splits (this
    process's own block rides along; the caller keeps its local copy)."""
    import torch.distributed as dist

    blocks = list(blocks)
    P = dist.get_world_size()
    if not blocks:
        return []
    send, offs = _pack_rows(blocks, P)
    recv = torch.empty_like(send)
    _finish(dist.all_to_all_single(recv.view(-1), send.contiguous().view(-1),
                                   async_op=True),
            timeout_s, what)
    return _unpack_rows(recv, offs, blocks, [tuple(b.shape) for b in blocks])


def peer_plan(n: int, L: int, p: int) -> List[Tuple[int, int]]:
    """The per-call segment plan of process ``p``, which holds global
    shards ``[p*L, (p+1)*L)`` of ``n``: entry ``s*n + d`` says where
    segment d of local source shard s goes (its bytes start at segment
    ``s*n + d`` of the ``[L, n*Q, *tail]`` send buffer), as (the owner
    process q, the segment index in q's ``[L, n*Q, *tail]`` receive buffer
    of the column, in units of Q rows). Destination shard d is q's local
    shard ``d % L``, and there the segment sits at source position
    ``p*L + s``: rows arrive source-major, as on one card."""
    if n < 1 or L < 1 or n % L or not 0 <= p < n // L:
        raise ValueError(f"peer_plan: process {p} with {L} of {n} shards")
    return [(d // L, (d % L) * n + p * L + s) for s in range(L) for d in range(n)]


class SyncOp(NamedTuple):
    """One stream memory operation of the peer exchange's schedule: a
    ``"write"`` of ``value`` into process ``owner``'s generation word
    ``written[index]``, or a ``"wait"`` until that word of this process's
    own page (``owner`` is this process) is at least ``value``."""

    kind: str       # "write" | "wait"
    owner: int      # the process whose page holds the word
    index: int      # the process the word speaks for
    value: int


def peer_schedule(step: int, P: int, p: int) -> List[SyncOp]:
    """The writes and waits process ``p`` of ``P`` puts on its stream
    after the kernel of the call at ``step`` (its ``step``-th call on one
    arena). The call writes half ``b = step % 2`` of every process's arena
    and returns this process's half b; the caller reads it before its next
    call on the same stream. Word ``written[q]`` of p's page is 1 + the
    last step whose kernel q finished; words start at 0 and only grow, so
    a wait for "at least" is right whenever the stream reaches it.

    First tell every peer q that p's writes of this step are done
    (``written[p] = step + 1`` in q's page), then wait until every peer
    has done the same in p's page: every writer of p's half b has
    finished (read after write), and p's reads may start. The same waits
    order the next use of the other half (write after read): a peer's
    ``written`` at ``step + 1`` means its stream ran past its kernel of
    ``step``, so past its reads of ``step - 1``'s result, which precede
    that call; p overwrites that half only at ``step + 1``, after these
    waits. Last, ``written[p] = step + 1`` in p's own page: the call's
    waits have passed (the watchdog reads it on the host). Nothing waits
    before the kernel, and nothing waits on the host (the model in
    ``tests/test_torch_peer_exchange.py`` explores every interleaving)."""
    peers = [q for q in range(P) if q != p]
    return ([SyncOp("write", q, p, step + 1) for q in peers]
            + [SyncOp("wait", p, q, step + 1) for q in peers]
            + [SyncOp("write", p, p, step + 1)])


def word_offset(index: int) -> int:
    """The byte offset of word ``written[index]`` in a page of words."""
    return 8 * index


def _check_process_cols(bufs: Sequence[torch.Tensor], n: int, L: int) -> None:
    for buf in bufs:
        if buf.dim() < 2 or buf.shape[0] != L or buf.shape[1] % n:
            raise ValueError(
                f"process exchange: buf must be [L, n*Q, ...] with L={L}, n={n}, "
                f"got {tuple(buf.shape)}")
        if not buf.is_contiguous():
            raise ValueError("process exchange: buf must be contiguous")
        if buf.device != bufs[0].device:
            raise ValueError(
                f"process exchange: buffers on {bufs[0].device} and {buf.device}")


def process_exchange_plain(sent: Sequence[torch.Tensor], n: int, L: int, p: int,
                           timeout_s=None, what: str = "shard exchange") -> List[torch.Tensor]:
    """Move every column's send buckets of process ``p`` to their owners:
    ``sent[i]`` is ``[L, n*Q, *tail]`` (this process's source shards;
    segment d bound for global shard d). The pairs between this process's
    own shards take ``ring_exchange_cols`` (one launch for every column on
    a card); the buckets of other processes' shards travel in one
    ``all_to_all_single`` (its own block rides along and is dropped for
    the kernel's). Returns ``[L, n*Q, *tail]`` per column: this process's
    shards' receive buffers, source-major over all n sources. The plain
    version of ``peer_exchange_cols``."""
    sent = list(sent)
    _check_process_cols(sent, n, L)
    P = n // L
    Q = sent[0].shape[1] // n
    tails = [tuple(b.shape[2:]) for b in sent]
    # [L_src, P, L_dst, Q, *tail]
    blocks = [b.view((L, P, L, Q) + t) for b, t in zip(sent, tails)]
    own = [blk[:, p].reshape((L, L * Q) + t) for blk, t in zip(blocks, tails)]
    own = ring_exchange_cols([o.contiguous() for o in own], L) if L > 1 else own
    # [P_dst, L_src, L_dst, Q, *tail] -> from every process
    recv = all_to_all_cols([blk.transpose(0, 1).contiguous() for blk in blocks],
                           timeout_s, what)
    out = []
    for r, o, t in zip(recv, own, tails):
        full = r.permute((2, 0, 1, 3) + tuple(range(4, 4 + len(t)))).contiguous()
        full[:, p] = o.view((L, L, Q) + t)     # [L_dst, P, L_src, Q, *tail]
        out.append(full.reshape((L, n * Q) + t))
    return out


def _fatal(what: str):
    """The error a failed peer exchange raises: fatal for the runtime, so
    it reaches the sender (a dropped batch would leave the processes out
    of step)."""
    from siddhi_tpu_torch.core.stream.junction import FatalQueryError

    return FatalQueryError(what)


class _DeviceBytes:
    """``nbytes`` of device memory at ``ptr`` as a 1-d uint8 array (the
    CUDA array interface), for a zero-copy torch tensor over it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


class _Arena:
    """One column layout's receive arena in this process (two halves, by
    step parity) and its page of generation words, and every process's as
    mapped here."""

    def __init__(self, specs, offsets, half: int):
        self.specs, self.offsets, self.half = specs, offsets, half
        self.bases = None       # c_ulonglong[P]: each process's arena here
        self.words = []         # [q]: process q's page of words, on the card
        self.own = None         # c_ulonglong[P]: this process's page, on the host
        self.views = []         # [parity]: this process's receive buffers
        self.step = 0


def _release(res: dict) -> List[str]:
    """Stop the watchdog, then unmap and free every recorded handle,
    newest first; returns the failures' messages."""
    watch = res.pop("watch", None)
    if watch is not None:
        watch.stop()
    lib, handles, errors = res["lib"], res["handles"], []
    while handles:
        kind, ptr = handles.pop()
        fn = {"close": lib.siddhi_ipc_close, "free": lib.siddhi_ipc_free,
              "words": lib.siddhi_words_close, "fd": lib.siddhi_fd_close}[kind]
        code = fn(ptr)
        if code:
            errors.append(f"{kind} {ptr:#x}: CUDA error {code} "
                          f"({lib.siddhi_cuda_error_string(code).decode()})")
    return errors


class _Watchdog:
    """Bounds the waits a peer exchange leaves on its stream. Each call
    hands it (this process's page of words for the arena, the index of
    the word the stream writes once the call's waits have passed, the
    value it writes, a deadline) through a queue nobody blocks on, so the
    hand-over wakes no thread; a daemon thread polls the queue every
    ``WATCH_TICK_S``, drops the calls whose words have arrived, oldest
    first, and calls ``fire()`` once if one is still short at its deadline
    (a peer that died or stalled past the bound: ``fire`` releases the
    stream, so no host read or launch hangs behind it). It reads host
    memory only and makes no CUDA call, which could block behind the
    launch queue the stuck stream filled."""

    def __init__(self, fire):
        self._fire = weakref.WeakMethod(fire)
        self._calls = queue.SimpleQueue()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="siddhi-peer-watchdog")
        self._thread.start()

    def watch(self, words, index: int, value: int, timeout_s: float) -> None:
        self._calls.put((words, index, value, time.monotonic() + float(timeout_s)))

    def stop(self) -> None:
        """Stop the thread and wait for it (the words it reads may be
        unmapped next)."""
        self._stopped.set()
        if self._thread is not threading.current_thread():
            self._thread.join()

    def _run(self) -> None:
        pending = collections.deque()       # (words, index, value, deadline), oldest first
        while not self._stopped.wait(WATCH_TICK_S):
            with contextlib.suppress(queue.Empty):
                while True:
                    pending.append(self._calls.get_nowait())
            while pending and pending[0][0][pending[0][1]] >= pending[0][2]:
                pending.popleft()
            if pending and pending[0][3] <= time.monotonic():
                fire = self._fire()
                if fire is not None:
                    fire()
                return


class PeerExchange:
    """The state of K8 across processes for process ``p`` of ``P``, each
    holding ``L`` of ``n`` shards on its card: per column layout one
    receive arena a process, mapped by every other through CUDA IPC, and
    a page of generation words a process in shared host memory (a memfd
    registered with the card), which orders the writes and reads.

    Who allocates: each arena is one ``cudaMalloc`` in the C source (an
    IPC handle names the whole allocation, so it must not come from
    torch's caching allocator), sized for every column of the layout at
    ``arena_layout``'s offsets, twice (by step parity). Every process lays
    its arena out alike, so the kernel takes one base a process and one
    offset a column. Beside it each process keeps a page of 64-bit words
    ``written[q]``, one for every process q, in shared host memory (a
    memfd, zero at birth, registered with the card), which every process
    maps through ``/proc/<pid>/fd``: so the processes must share a host
    and a PID namespace, as CUDA IPC needs them on one host anyway. The
    arena's IPC handle and the page's pid and fd are traded with one
    ``all_gather`` over the group when a layout first crosses (the first
    dispatch, which every process makes together) and checked to describe
    the same columns everywhere; a barrier then follows, so no process
    writes before every process has mapped everything. The card must take
    64-bit stream memory operations (asked once); if it does not, the
    first call raises ``FatalQueryError``.

    A call puts on the caller's stream one launch of the kernel (every
    column, every pair of ``peer_plan``), then exactly what
    ``peer_schedule`` gives for the arena's step: its writes into the
    peers' pages and its waits on its own. It makes no host call that
    waits: no barrier, no collective, no event. The result is this
    process's half as tensors, read before the next call on the stream.

    A dead or stalled peer leaves the stream waiting on a word. The next
    bounded read catches it: the egress's gathers, a ``guarded_pull``, or
    the watchdog (``_Watchdog``), which at ``timeout_s`` (the app's
    ``cluster_step_timeout``, else the group's timeout) after a call
    whose waits have not passed marks the exchange failed and stores
    ``RELEASED`` into this process's own words on the host, so its stream
    drains and no host read or launch hangs behind it. A failed exchange
    raises ``ClusterPeerError`` at every later call, before any device
    work, and at ``check`` (the routed step's, after its egress: rows read
    from a released half are never emitted). Double buffering rather than
    a copy out of the arena: the result is read by the step that follows
    on the same stream, and the peers' waits of the next call cover every
    such read (``peer_schedule``). A failed CUDA call raises
    ``FatalQueryError``; nothing falls back to the collective."""

    def __init__(self, n: int, L: int, P: int, p: int):
        if P * L != n or not 0 <= p < P:
            raise ValueError(f"PeerExchange: process {p} of {P} with {L} of {n} shards")
        if P > MAX_PEER_PROCS or L * n > MAX_PEER_PAIRS:
            raise ValueError(
                f"PeerExchange: {P} processes and {L * n} segment pairs a column "
                f"exceed the kernel's table ({MAX_PEER_PROCS}, {MAX_PEER_PAIRS})")
        self.n, self.L, self.P, self.p = n, L, P, p
        self._plan = (ctypes.c_uint * (L * n))(
            *[q << 24 | seg for q, seg in peer_plan(n, L, p)])
        self._arenas: Dict[tuple, _Arena] = {}
        self._group = None
        self._device = None
        self._flush = None      # the card flushes remote writes after a wait
        self._broken = None     # the error that failed the exchange
        self._res = {"lib": None, "handles": []}
        self._finalizer = weakref.finalize(self, _release, self._res)

    def _lib(self):
        lib = self._res["lib"]
        if lib is None:
            try:
                lib = _cuda.load("ring_exchange", _bind)
            except RuntimeError as ex:
                raise _fatal(f"peer exchange: the kernel did not build: {ex}") from ex
            self._res["lib"] = lib
        return lib

    def _ok(self, code: int, what: str) -> None:
        if code != 0:
            msg = self._res["lib"].siddhi_cuda_error_string(code).decode()
            raise _fatal(f"peer exchange of process {self.p}: {what}: CUDA "
                         f"error {code} ({msg})")

    def _barrier_group(self):
        import torch.distributed as dist

        if self._group is None:
            # a host barrier: gloo on CPU tensors (an NCCL group's
            # collectives would only order streams)
            self._group = (dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))
        return self._group

    def check(self, what: str) -> None:
        """Raise ``ClusterPeerError`` if the exchange has failed."""
        if self._broken is not None:
            from siddhi_tpu_torch.parallel.distributed import ClusterPeerError

            raise ClusterPeerError(
                f"{what}: the peer exchange of process {self.p} failed at an "
                f"earlier step ({self._broken})")

    def _barrier(self, timeout_s, what: str) -> None:
        """A host barrier over the group (mapping and release only); a
        failed one fails the exchange for good."""
        import torch.distributed as dist

        from siddhi_tpu_torch.parallel.distributed import ClusterPeerError

        self.check(what)
        try:
            _finish(dist.all_reduce(torch.zeros(1, dtype=torch.int32),
                                    group=self._barrier_group(), async_op=True),
                    timeout_s, what)
        except ClusterPeerError as ex:
            self._broken = ex
            raise

    def _trade(self, payload: bytes, timeout_s, what: str) -> List[bytes]:
        """Every process's payload (the same length), in process order."""
        import torch.distributed as dist

        row = torch.tensor(list(payload), dtype=torch.uint8)
        parts = [torch.empty_like(row) for _ in range(self.P)]
        _finish(dist.all_gather(parts, row, group=self._barrier_group(), async_op=True),
                timeout_s, what)
        return [bytes(part.tolist()) for part in parts]

    def _handle(self, kind: str, ptr: int) -> int:
        self._res["handles"].append((kind, ptr))
        return ptr

    def _check_card(self, lib) -> None:
        """Once: the card must take 64-bit stream memory operations."""
        ok, flush = ctypes.c_int(), ctypes.c_int()
        self._ok(lib.siddhi_stream_memops(ctypes.byref(ok), ctypes.byref(flush)),
                 "the driver's stream memory operations (cuStreamBatchMemOp_v2, "
                 "cuDeviceGetAttribute through libcuda.so.1)")
        if not ok.value:
            raise _fatal(
                f"peer exchange: the card {self._device} does not take 64-bit stream "
                "memory operations (CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS "
                "is 0), on which the exchange's completion rests; nothing falls back")
        self._flush = bool(flush.value)

    def _open(self, bufs, device, timeout_s, what: str) -> _Arena:
        import os

        lib = self._lib()
        if self._flush is None:
            self._check_card(lib)
        specs = [(tuple(b.shape), b.dtype) for b in bufs]
        offsets, end = arena_layout(specs)
        arena = _Arena(specs, offsets, -(-end // ARENA_ALIGN) * ARENA_ALIGN)
        total = 2 * arena.half
        ptr, mem = ctypes.c_void_p(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        self._ok(lib.siddhi_ipc_alloc(total, ctypes.byref(ptr), mem),
                 f"cudaMalloc of a {total}-byte receive arena")
        self._handle("free", ptr.value)
        fd, host, dev = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_ulonglong()
        self._ok(lib.siddhi_words_create(ctypes.byref(fd), ctypes.byref(host),
                                         ctypes.byref(dev)),
                 "the page of generation words (memfd_create, mmap, cudaHostRegister)")
        self._handle("words", host.value)
        self._handle("fd", fd.value)
        arena.own = (ctypes.c_ulonglong * self.P).from_address(host.value)
        sig = zlib.crc32(repr([(s, str(d)) for s, d in specs]).encode())
        tag = sig.to_bytes(8, "little") + total.to_bytes(8, "little")
        page = os.getpid().to_bytes(8, "little") + fd.value.to_bytes(8, "little")
        rows = self._trade(mem.raw + page + tag, timeout_s, what)
        H = IPC_HANDLE_BYTES
        bases, words = [], []
        for q, row in enumerate(rows):
            if row[H + 16:] != tag:
                raise _fatal(f"peer exchange: process {q}'s columns differ from "
                             f"process {self.p}'s ({specs})")
            if q == self.p:
                bases.append(ptr.value)
                words.append(dev.value)
                continue
            base = ctypes.c_void_p()
            self._ok(lib.siddhi_ipc_open(row[:H], ctypes.byref(base)),
                     f"cudaIpcOpenMemHandle of process {q}'s receive arena")
            bases.append(self._handle("close", base.value))
            pid, qfd = (int.from_bytes(row[H + i:H + i + 8], "little") for i in (0, 8))
            qhost, qdev = ctypes.c_void_p(), ctypes.c_ulonglong()
            self._ok(lib.siddhi_words_open(pid, qfd, ctypes.byref(qhost), ctypes.byref(qdev)),
                     f"process {q}'s page of generation words (/proc/{pid}/fd/{qfd})")
            self._handle("words", qhost.value)
            words.append(qdev.value)
        arena.bases = (ctypes.c_ulonglong * self.P)(*bases)
        arena.words = words
        # every process has mapped every arena and page before any writes
        self._barrier(timeout_s, what)
        whole = torch.as_tensor(_DeviceBytes(ptr.value, total))
        if whole.device != device or whole.data_ptr() != ptr.value:
            raise _fatal(f"peer exchange: the arena's view lies at {whole.device} "
                         f"{whole.data_ptr():#x}, not {device} {ptr.value:#x}")
        arena.views = [_views(whole.untyped_storage(), b * arena.half, specs, offsets,
                              device) for b in (0, 1)]
        return arena

    def _sync(self, arena: _Arena, ops: Sequence[SyncOp], stream) -> None:
        """Put ``ops`` on ``stream``, in order, as one batch."""
        if not ops:
            return
        flush = int(self._flush)
        table = (_PeerSync * len(ops))(*[
            _PeerSync(arena.words[op.owner] + word_offset(op.index), op.value,
                      op.kind == "wait", flush if op.kind == "wait" else 0)
            for op in ops])
        self._ok(self._res["lib"].siddhi_stream_sync(table, len(ops), stream),
                 "the stream's writes and waits of generation words")

    def _fail(self, error=None) -> None:
        """Mark the exchange failed and release every wait its stream may
        be stuck on: ``RELEASED`` stored into each of this process's own
        words of every arena, on the host (no CUDA call), so the stream
        drains; rows read from a released half are refused by ``check``."""
        from siddhi_tpu_torch.parallel.distributed import ClusterPeerError

        if self._broken is None:
            self._broken = error or ClusterPeerError(
                f"the peer exchange of process {self.p}: a call's waits on its peers' "
                f"generation words did not pass within the step's bound — a cluster "
                f"peer process is presumed dead; this error is terminal for the "
                f"runtime: abandon it, restart the cluster and restore from the last "
                f"snapshot revision")
        for arena in list(self._arenas.values()):
            for q in range(self.P):
                if q != self.p:
                    arena.own[q] = RELEASED

    def _watch(self, arena: _Arena, timeout_s) -> None:
        """Hand the call just made to the watchdog: its own word reaches
        ``arena.step + 1`` once its waits have passed."""
        watch = self._res.get("watch")
        if watch is None:
            watch = self._res["watch"] = _Watchdog(self._fail)
        if timeout_s is None:
            from siddhi_tpu_torch.parallel.distributed import group_timeout_s

            timeout_s = group_timeout_s()
        watch.watch(arena.own, self.p, arena.step + 1, timeout_s)

    def exchange(self, bufs: Sequence[torch.Tensor], timeout_s=None,
                 what: str = "shard exchange") -> List[torch.Tensor]:
        """This process's receive buffers ``[L, n*Q, *tail]`` of every
        column (the views of its arena's half for this step: read them
        before the next call on this stream), from every process's send
        buffers."""
        n, L, P, p = self.n, self.L, self.P, self.p
        device = bufs[0].device
        guard = (torch.cuda.device(device) if device.index != torch.cuda.current_device()
                 else contextlib.nullcontext())
        with guard:
            self.check(what)
            self._device = device
            sig = tuple((tuple(b.shape), b.dtype) for b in bufs)
            arena = self._arenas.get(sig)
            if arena is None:
                arena = self._arenas[sig] = self._open(bufs, device, timeout_s, what)
            lib = self._res["lib"]
            stream = torch.cuda.current_stream(device).cuda_stream
            b = arena.step & 1
            seg = [t.numel() // (L * n) * t.element_size() for t in bufs]
            off = b * arena.half
            for lo in range(0, len(bufs), MAX_PEER_COLS):
                part = range(lo, min(lo + MAX_PEER_COLS, len(bufs)))
                if not any(seg[i] for i in part):
                    continue            # nothing to move: no launch
                table = (_PeerCol * len(part))(
                    *[_PeerCol(bufs[i].data_ptr(), off + arena.offsets[i], seg[i])
                      for i in part])
                self._ok(lib.siddhi_peer_exchange_cols(table, len(part), arena.bases, P,
                                                       self._plan, L * n, stream),
                         "the kernel's launch")
                _cuda.count(peer_exchange_cols)
            self._sync(arena, peer_schedule(arena.step, P, p), stream)
            self._watch(arena, timeout_s)
            arena.step += 1
            return arena.views[b]

    def close(self, timeout_s=None, what: str = "peer exchange close") -> None:
        """Unmap the peers' arenas and free this process's, behind a
        device sync and a barrier (a re-install: no kernel of any process
        still writes into an arena this one frees or unmaps). Every
        process of the group calls it together. After a failure (a dead
        peer) neither: the stream was released, and the peers are gone."""
        try:
            if self._arenas and self._broken is None:
                with torch.cuda.device(self._device):
                    torch.cuda.synchronize()
                if self._broken is None:
                    self._barrier(timeout_s, what)
        finally:
            watch = self._res.pop("watch", None)
            if watch is not None:
                watch.stop()
        self._arenas.clear()
        errors = _release(self._res) if self._res["handles"] else []
        if errors:
            raise _fatal(f"peer exchange of process {self.p}: release failed: "
                         + "; ".join(errors))


def peer_exchange_cols(bufs: Sequence[torch.Tensor], peer: PeerExchange, timeout_s=None,
                       what: str = "shard exchange") -> List[torch.Tensor]:
    """K8 across processes: every column's send buffers ``[L, n*Q, *tail]``
    of this process (``peer``'s) moved to their owners by one launch of the
    kernel, which writes each segment straight into its owner process's
    receive arena (``PeerExchange``). Returns this process's receive
    buffers, as ``process_exchange_plain`` does, which is its plain
    version and runs only for CPU tensors."""
    bufs = list(bufs)
    _check_process_cols(bufs, peer.n, peer.L)
    if not bufs:
        return []
    device = bufs[0].device
    if device.type == "cpu":
        return process_exchange_plain(bufs, peer.n, peer.L, peer.p, timeout_s, what)
    if device.type != "cuda":
        raise ValueError(f"peer exchange: unsupported device {device}")
    return peer.exchange(bufs, timeout_s, what)


peer_exchange_cols.launches = 0


def all_gather_rows(tensors: Sequence[torch.Tensor], timeout_s=None,
                    what: str = "egress gather") -> List[List[torch.Tensor]]:
    """Every process's row-aligned tensors (one leading row dim, the same
    row count within a process, any count across processes): one
    ``all_gather`` of the row counts, then one of the packed rows padded
    to the longest. Returns, per tensor, the list of every process's rows
    in process order."""
    import torch.distributed as dist

    tensors = list(tensors)
    P = dist.get_world_size()
    rows = int(tensors[0].shape[0])
    dev = tensors[0].device
    mine = torch.tensor([rows], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(mine) for _ in range(P)]
    _finish(dist.all_gather(counts, mine, async_op=True), timeout_s, what)
    counts = [int(c.cpu()[0]) for c in counts]      # the sizes of the rows
    top = max(counts)
    if top == 0:
        return [[t for _ in range(P)] for t in tensors]
    padded = [torch.cat([t, torch.zeros((top - rows,) + tuple(t.shape[1:]),
                                        dtype=t.dtype, device=dev)])
              if top > rows else t for t in tensors]
    buf, offs = _pack_rows(padded, top)
    flat = buf.reshape(-1).contiguous()
    parts = [torch.empty_like(flat) for _ in range(P)]
    _finish(dist.all_gather(parts, flat, async_op=True), timeout_s, what)
    out = [[] for _ in tensors]
    for q, part in enumerate(parts):
        cols = _unpack_rows(part.view(top, -1), offs, padded,
                            [(top,) + tuple(t.shape[1:]) for t in padded])
        for i, c in enumerate(cols):
            out[i].append(c[:counts[q]])
    return out


def all_gather_same(tensors: Sequence[torch.Tensor], timeout_s=None,
                    what: str = "state gather") -> List[List[torch.Tensor]]:
    """Tensors of the same shapes and dtypes in every process, from every
    process: one ``all_gather`` of them packed into one byte row. Returns,
    per tensor, the list of every process's copy in process order."""
    import torch.distributed as dist

    tensors = list(tensors)
    flat = [t.reshape(1, -1) for t in tensors]
    buf, offs = _pack_rows(flat, 1)
    row = buf.reshape(-1).contiguous()
    parts = [torch.empty_like(row) for _ in range(dist.get_world_size())]
    _finish(dist.all_gather(parts, row, async_op=True), timeout_s, what)
    out = [[] for _ in tensors]
    for part in parts:
        cols = _unpack_rows(part.view(1, -1), offs, flat, [tuple(f.shape) for f in flat])
        for i, (c, t) in enumerate(zip(cols, tensors)):
            out[i].append(c.reshape(t.shape))
    return out
