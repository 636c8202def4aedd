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
