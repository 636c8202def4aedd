"""The shard exchange of the device-routed step: ``ring_exchange``.

Counterpart of ``siddhi_tpu/parallel/mesh.py:1242`` (``_pallas_ring_exchange``,
the repo's one Pallas TPU kernel) and of the ``lax.all_to_all(tiled=True)``
it stands for. On one card the n logical shards' send buffers are rows of
one ``[n, n*Q, *tail]`` tensor, and

    out[d, s*Q:(s+1)*Q] = buf[s, d*Q:(d+1)*Q]

i.e. segment d of shard s goes to shard d, and rows arrive source-major.

``ring_exchange`` launches the hand-written CUDA kernel
(``csrc/ring_exchange.cu``) for a CUDA tensor and uses the plain version
only for a CPU tensor; there is no fallback for a CUDA tensor.
``ring_exchange.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch


def _check(buf: torch.Tensor, n: int) -> int:
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"ring_exchange: n must be a positive int, got {n!r}")
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
    return buf.shape[1] // n


def _bind(lib) -> None:
    fn = lib.siddhi_ring_exchange
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]


def ring_exchange_plain(buf: torch.Tensor, n: int) -> torch.Tensor:
    """The exchange in plain torch ops (the kernel's reference)."""
    Q = _check(buf, n)
    tail = tuple(buf.shape[2:])
    return buf.view(n, n, Q, *tail).transpose(0, 1).reshape(n, n * Q, *tail)


def ring_exchange(buf: torch.Tensor, n: int) -> torch.Tensor:
    """Exchange segments between n co-resident shards (see module doc)."""
    Q = _check(buf, n)
    if buf.device.type == "cpu":
        return ring_exchange_plain(buf, n)
    if buf.device.type != "cuda":
        raise ValueError(f"ring_exchange: unsupported device {buf.device}")
    from siddhi_tpu_torch.ops import _cuda

    lib = _cuda.load("ring_exchange", _bind)
    out = torch.empty_like(buf)
    seg_bytes = Q * buf.element_size() * math.prod(buf.shape[2:])
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        code = lib.siddhi_ring_exchange(buf.data_ptr(), out.data_ptr(), n,
                                        seg_bytes, stream)
    _cuda.check(lib, code, "ring_exchange launch")
    ring_exchange.launches += 1
    return out


ring_exchange.launches = 0
