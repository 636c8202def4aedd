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

Across processes (``parallel/distributed.py``) the rows bound for another
process's shards travel in ``all_to_all_cols``: every column's blocks
packed into one byte buffer and moved by ONE
``torch.distributed.all_to_all_single`` (the counterpart of the
reference's ``lax.all_to_all`` between hosts, an XLA collective and not
Pallas). ``all_gather_rows`` is the
egress: one ``all_gather`` of every process's emitted rows, padded to the
longest. Both are plain collectives of the process group, NCCL between
cards and gloo between CPU processes.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from siddhi_tpu_torch.ops import _cuda

MAX_COLS = 64          # columns one launch takes (the kernel's table size)
ARENA_ALIGN = 128      # byte alignment of every output in the arena


class _ExchangeCol(ctypes.Structure):
    """One column of the kernel's table (``ExchangeCol`` in the source)."""

    _fields_ = [("inp", ctypes.c_void_p), ("out", ctypes.c_void_p),
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


def _bind(lib) -> None:
    fn = lib.siddhi_ring_exchange_cols
    fn.restype = ctypes.c_int
    # the stream as c_void_p: a plain int would be cut to 32 bits
    fn.argtypes = [ctypes.POINTER(_ExchangeCol), ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]


def arena_views(specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                device) -> List[torch.Tensor]:
    """Contiguous tensors of the given (shape, dtype)s as views of ONE
    ``torch.empty`` byte arena on ``device``, each starting at a multiple
    of ``ARENA_ALIGN`` bytes (one allocation; aligned starts for the
    kernel's bulk copies)."""
    offsets, end = [], 0
    for shape, dtype in specs:
        start = -(-end // ARENA_ALIGN) * ARENA_ALIGN
        offsets.append(start)
        end = start + math.prod(shape) * dtype.itemsize
    arena = torch.empty(end + ARENA_ALIGN, dtype=torch.uint8, device=device)
    base = -arena.data_ptr() % ARENA_ALIGN
    storage = arena.untyped_storage()
    # one set_ per output (a slice and two views cost three ops each)
    return [torch.empty(0, dtype=dtype, device=device).set_(
                storage, (base + off) // dtype.itemsize, shape)
            for (shape, dtype), off in zip(specs, offsets)]


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
