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
  (one card, or cards with peer access). Its plain version, for CPU
  tensors, is ``process_exchange_plain``; on a card nothing falls back.

``all_gather_rows`` is the egress: one ``all_gather`` of every process's
emitted rows, padded to the longest. The collectives are the process
group's, NCCL between cards and gloo between CPU processes.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import weakref
import zlib
from typing import Dict, List, Sequence, Tuple

import torch

from siddhi_tpu_torch.ops import _cuda

MAX_COLS = 64          # columns one launch takes (the kernel's table size)
ARENA_ALIGN = 128      # byte alignment of every output in the arena
# the cross-process entry's table (csrc/ring_exchange.cu PeerTable)
MAX_PEER_COLS = 32
MAX_PEER_PROCS = 16
MAX_PEER_PAIRS = 512
IPC_HANDLE_BYTES = 64  # cudaIpcMemHandle_t and cudaIpcEventHandle_t


class _ExchangeCol(ctypes.Structure):
    """One column of the kernel's table (``ExchangeCol`` in the source)."""

    _fields_ = [("inp", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("seg_bytes", ctypes.c_longlong)]


class _PeerCol(ctypes.Structure):
    """One column of the cross-process table (``PeerCol`` in the source)."""

    _fields_ = [("inp", ctypes.c_void_p), ("out_off", ctypes.c_longlong),
                ("seg_bytes", ctypes.c_longlong)]


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
    _declare(lib.siddhi_ring_exchange_cols, ptr(_ExchangeCol), i32, ctypes.c_longlong, vp)
    _declare(lib.siddhi_peer_exchange_cols, ptr(_PeerCol), i32, ptr(ctypes.c_ulonglong),
             i32, ptr(ctypes.c_uint), i32, vp)
    _declare(lib.siddhi_ipc_alloc, ctypes.c_longlong, ptr(vp), ctypes.c_char_p)
    _declare(lib.siddhi_ipc_free, vp)
    _declare(lib.siddhi_ipc_open, ctypes.c_char_p, ptr(vp))
    _declare(lib.siddhi_ipc_close, vp)
    _declare(lib.siddhi_ipc_event_create, ptr(vp), ctypes.c_char_p)
    _declare(lib.siddhi_ipc_event_open, ctypes.c_char_p, ptr(vp))
    _declare(lib.siddhi_event_destroy, vp)
    _declare(lib.siddhi_event_record, vp, vp)
    _declare(lib.siddhi_stream_wait_event, vp, vp)


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
    step parity) with its events, and every process's as mapped here."""

    def __init__(self, specs, offsets, half: int):
        self.specs, self.offsets, self.half = specs, offsets, half
        self.bases = None       # c_ulonglong[P]: each process's arena here
        self.written = []       # [q][parity]: q's kernel of the step is done
        self.consumed = []      # [q][parity]: q has read that half
        self.views = []         # [parity]: this process's receive buffers
        self.step = 0


def _release(res: dict) -> List[str]:
    """Unmap, destroy and free every recorded handle, newest first;
    returns the failures' messages."""
    lib, handles, errors = res["lib"], res["handles"], []
    while handles:
        kind, ptr = handles.pop()
        fn = {"close": lib.siddhi_ipc_close, "free": lib.siddhi_ipc_free,
              "event": lib.siddhi_event_destroy}[kind]
        code = fn(ptr)
        if code:
            errors.append(f"{kind} {ptr:#x}: CUDA error {code} "
                          f"({lib.siddhi_cuda_error_string(code).decode()})")
    return errors


class PeerExchange:
    """The state of K8 across processes for process ``p`` of ``P``, each
    holding ``L`` of ``n`` shards on its card: per column layout one
    receive arena a process, mapped by every other through CUDA IPC, and
    the interprocess events that order the writes and reads.

    Who allocates: each arena is one ``cudaMalloc`` in the C source (an
    IPC handle names the whole allocation, so it must not come from
    torch's caching allocator), sized for every column of the layout at
    ``arena_layout``'s offsets, twice (by step parity). Every process lays
    its arena out alike, so the kernel takes one base a process and one
    offset a column. The handles (64 bytes each: the arena and four
    events) are traded with one ``all_gather`` over the group when a
    layout first crosses (the first dispatch, which every process makes
    together), and checked to describe the same columns everywhere.

    A call (step k, parity b = k % 2), on the caller's stream:

    1. wait for every peer's ``consumed[b]``: its reads of half b at step
       k-2 are done before this kernel overwrites it (write after read);
       record ``consumed[1-b]`` (this process's reads of step k-1 precede
       this point on its stream);
    2. launch the kernel (every column, every pair of ``peer_plan``), then
       record ``written[b]``;
    3. a host barrier over the group (gloo, bounded by the app's
       ``cluster_step_timeout``): a wait on an event not yet recorded
       would return at once, so every record of step 1–2 precedes every
       wait of step 4;
    4. wait for every peer's ``written[b]`` (read after write) and return
       this process's half b as tensors.

    A barrier also follows the opening of every mapping, so no kernel
    writes before every process has mapped every arena; after a failed
    barrier (a dead peer: ``ClusterPeerError``) every later call raises at
    once, before any device work.

    Double buffering rather than a copy out of the arena: the result is
    read by the step that follows on the same stream, and the consumed
    event recorded at the next call covers every such read without a
    second copy of the columns. Every wait is a stream wait on an event:
    nothing spins on the device for another process. A failed CUDA call
    raises ``FatalQueryError``; nothing falls back to the collective."""

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
        self._broken = None     # the failed barrier's error
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

    def _barrier(self, timeout_s, what: str) -> None:
        """A host barrier over the group; a failed one leaves the group out
        of step for good: later calls raise at once, before any device
        work (no kernel writes into the arena of a peer that is gone)."""
        import torch.distributed as dist

        from siddhi_tpu_torch.parallel.distributed import ClusterPeerError

        if self._broken is not None:
            raise ClusterPeerError(
                f"{what}: the peer exchange of process {self.p} failed at an "
                f"earlier step ({self._broken})")
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

    def _open(self, bufs, device, timeout_s, what: str) -> _Arena:
        lib = self._lib()
        specs = [(tuple(b.shape), b.dtype) for b in bufs]
        offsets, end = arena_layout(specs)
        arena = _Arena(specs, offsets, -(-end // ARENA_ALIGN) * ARENA_ALIGN)
        ptr, mem = ctypes.c_void_p(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        self._ok(lib.siddhi_ipc_alloc(2 * arena.half, ctypes.byref(ptr), mem),
                 f"cudaMalloc of a {2 * arena.half}-byte receive arena")
        self._handle("free", ptr.value)
        own, payload = [], [mem.raw]
        for _ in range(4):          # written[0, 1], consumed[0, 1]
            ev, h = ctypes.c_void_p(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
            self._ok(lib.siddhi_ipc_event_create(ctypes.byref(ev), h),
                     "an interprocess event")
            own.append(self._handle("event", ev.value))
            payload.append(h.raw)
        sig = zlib.crc32(repr([(s, str(d)) for s, d in specs]).encode())
        payload.append(sig.to_bytes(8, "little") + (2 * arena.half).to_bytes(8, "little"))
        rows = self._trade(b"".join(payload), timeout_s, what)
        H = IPC_HANDLE_BYTES
        bases, arena.written, arena.consumed = [], [], []
        for q, row in enumerate(rows):
            if row[-16:] != payload[-1]:
                raise _fatal(f"peer exchange: process {q}'s columns differ from "
                             f"process {self.p}'s ({specs})")
            if q == self.p:
                bases.append(ptr.value)
                evs = own
            else:
                base = ctypes.c_void_p()
                self._ok(lib.siddhi_ipc_open(row[:H], ctypes.byref(base)),
                         f"cudaIpcOpenMemHandle of process {q}'s receive arena")
                bases.append(self._handle("close", base.value))
                evs = []
                for i in range(1, 5):
                    ev = ctypes.c_void_p()
                    self._ok(lib.siddhi_ipc_event_open(row[i * H:(i + 1) * H],
                                                       ctypes.byref(ev)),
                             f"cudaIpcOpenEventHandle of process {q}'s event {i - 1}")
                    evs.append(self._handle("event", ev.value))
            arena.written.append(evs[:2])
            arena.consumed.append(evs[2:])
        arena.bases = (ctypes.c_ulonglong * self.P)(*bases)
        # every process has mapped every arena before any kernel writes
        self._barrier(timeout_s, what)
        whole = torch.as_tensor(_DeviceBytes(ptr.value, 2 * arena.half))
        if whole.device != device or whole.data_ptr() != ptr.value:
            raise _fatal(f"peer exchange: the arena's view lies at {whole.device} "
                         f"{whole.data_ptr():#x}, not {device} {ptr.value:#x}")
        arena.views = [_views(whole.untyped_storage(), b * arena.half, specs, offsets,
                              device) for b in (0, 1)]
        return arena

    def exchange(self, bufs: Sequence[torch.Tensor], timeout_s=None,
                 what: str = "shard exchange") -> List[torch.Tensor]:
        """This process's receive buffers ``[L, n*Q, *tail]`` of every
        column (the views of its arena's half for this step; valid until
        the call after next), from every process's send buffers."""
        n, L, P, p = self.n, self.L, self.P, self.p
        device = bufs[0].device
        guard = (torch.cuda.device(device) if device.index != torch.cuda.current_device()
                 else contextlib.nullcontext())
        with guard:
            if self._broken is not None:
                self._barrier(timeout_s, what)      # raises: the group is gone
            self._device = device
            sig = tuple((tuple(b.shape), b.dtype) for b in bufs)
            arena = self._arenas.get(sig)
            if arena is None:
                arena = self._arenas[sig] = self._open(bufs, device, timeout_s, what)
            lib = self._res["lib"]
            stream = torch.cuda.current_stream(device).cuda_stream
            b = arena.step & 1
            for q in range(P):
                if q != p:
                    self._ok(lib.siddhi_stream_wait_event(stream, arena.consumed[q][b]),
                             f"a wait on process {q}'s reads")
            self._ok(lib.siddhi_event_record(arena.consumed[p][b ^ 1], stream),
                     "the record of this process's reads")
            seg = [t.numel() // (L * n) * t.element_size() for t in bufs]
            for lo in range(0, len(bufs), MAX_PEER_COLS):
                part = range(lo, min(lo + MAX_PEER_COLS, len(bufs)))
                if not any(seg[i] for i in part):
                    continue            # nothing to move: no launch
                table = (_PeerCol * len(part))(
                    *[_PeerCol(bufs[i].data_ptr(), b * arena.half + arena.offsets[i],
                               seg[i]) for i in part])
                self._ok(lib.siddhi_peer_exchange_cols(table, len(part), arena.bases, P,
                                                       self._plan, L * n, stream),
                         "the kernel's launch")
                _cuda.count(peer_exchange_cols)
            self._ok(lib.siddhi_event_record(arena.written[p][b], stream),
                     "the record of this process's writes")
            self._barrier(timeout_s, what)
            for q in range(P):
                if q != p:
                    self._ok(lib.siddhi_stream_wait_event(stream, arena.written[q][b]),
                             f"a wait on process {q}'s writes")
            arena.step += 1
            return arena.views[b]

    def close(self, timeout_s=None, what: str = "peer exchange close") -> None:
        """Unmap the peers' arenas and free this process's, behind a
        device sync and a barrier (a re-install: no kernel of any process
        still writes into an arena this one frees or unmaps). Every
        process of the group calls it together."""
        if self._arenas and self._broken is None:
            with torch.cuda.device(self._device):
                torch.cuda.synchronize()
            self._barrier(timeout_s, what)
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
