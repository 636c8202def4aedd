"""The distinct scan of distinctCount and unionSet: ``distinct_scan``.

Counterpart of the ``lax.scan`` in ``siddhi_tpu/ops/aggregators.py:291``
(``_apply_distinct``), which XLA lowered to a sequential loop over every
row of a batch. Each group keeps an open table of H (value code, count)
slots: ``vk [K, H]`` int64 keys, ``vc [K, H]`` int32 counts (-1 never
used, 0 dead, both empty), ``stamp [K]`` int64, the epoch of the group's
last applied row. Row by row in arrival order, for row i of group g:

- a row whose epoch ``ep[i]`` differs from ``stamp[g]`` reads the table as
  empty (a RESET cleared it lazily); the stored table stays as it is
  unless the row applies;
- slot = the lowest slot whose count > 0 and whose key is the value, else
  the lowest slot whose count <= 0; with neither the table is full and an
  applying row overflows instead;
- a row applies iff it participates and found a slot: key and
  max(count + delta, 0) go into the slot, and ``stamp[g] = ep[i]``;
- ``nd[i]`` is the number of live (count > 0) slots after the row, and
  for unionSet the row's keys and live mask are its ``[H]`` snapshot;
- a multi-element set input ``set_in [R, Cin]`` (with its presence mask
  ``set_in_m``) folds its elements into one row, in order.

Rows of different groups are independent. ``distinct_scan`` launches the
hand-written CUDA kernel (``csrc/distinct_scan.cu``, one warp per group:
the table in registers up to ``SMALL_MAX_H`` slots, above it in shared
memory with a hash index of live slots and a free-slot bitmap, up to
``MAX_H``, and above that with the index and the bitmap in a global-memory
workspace this wrapper allocates, up to ``WIDE_MAX_H``) for CUDA tensors
and runs ``distinct_scan_plain`` for CPU tensors; there is no fallback
between them. Both
update the state IN PLACE and agree with the reference bit for bit,
state and outputs: the state crosses packages through ``interop.py``,
and unionSet snapshots expose slot order. ``distinct_scan.launches``
counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from siddhi_tpu_torch.ops import _cuda

# a launch on CUDA tensors makes no host read and runs on the current
# stream, allocating through torch: a CUDA graph may capture it once its
# library is loaded (core/query/step_graph.py warms up before capturing)
capturable = True

MAX_H = 16384         # slot ids are 16 bits in the shared-memory hash index
SMALL_MAX_H = 64      # the register table up to here, hash + bitmap above
WIDE_MAX_H = 1 << 26  # the global-index path: slot << 5 | lane fits an int
PATH_REGISTERS, PATH_HASH, PATH_WIDE = 0, 1, 2   # the kernel's designs
WIDE_BLOCKS_PER_SM = 2    # resident blocks of the global-index path


def _check(vk, vc, stamp, g, v, delta, part, ep, set_in, set_in_m) -> None:
    K, H = vk.shape
    if vk.dtype != torch.int64 or vc.dtype != torch.int32 or stamp.dtype != torch.int64:
        raise ValueError(
            f"distinct_scan: state dtypes vk {vk.dtype}, vc {vc.dtype}, stamp "
            f"{stamp.dtype}; want int64, int32, int64")
    if vc.shape != (K, H) or stamp.shape != (K,):
        raise ValueError(
            f"distinct_scan: state shapes vk {tuple(vk.shape)}, vc "
            f"{tuple(vc.shape)}, stamp {tuple(stamp.shape)}")
    if not (vk.is_contiguous() and vc.is_contiguous() and stamp.is_contiguous()):
        raise ValueError("distinct_scan: the state must be contiguous (it is "
                         "updated in place)")
    R = g.shape[0]
    rows = {"g": (g, torch.int64), "v": (v, torch.int64),
            "delta": (delta, torch.int32), "part": (part, torch.bool),
            "ep": (ep, torch.int64)}
    for name, (t, dt) in rows.items():
        if t.dtype != dt or t.shape != (R,):
            raise ValueError(f"distinct_scan: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, want {dt} [{R}]")
    if set_in is not None:
        if (set_in.dtype != torch.int64 or set_in_m is None
                or set_in_m.dtype != torch.bool or set_in.dim() != 2
                or set_in.shape[0] != R or set_in_m.shape != set_in.shape):
            raise ValueError("distinct_scan: set_in must be int64 [R, Cin] "
                             "with a bool set_in_m of the same shape")
    tensors = [vk, vc, stamp, g, v, delta, part, ep] + (
        [set_in, set_in_m] if set_in is not None else [])
    if any(t.device != vk.device for t in tensors):
        raise ValueError("distinct_scan: tensors on more than one device")


def _insert(vk_row, vc_row, val, d, apply_i):
    """One element into each of G tables at once ([G, H] rows)."""
    H = vk_row.shape[1]
    occupied = vc_row > 0
    match = occupied & (vk_row == val[:, None])
    has = match.any(1)
    empty = ~occupied
    # argmax of an all-False row is 0: a full table "chooses" slot 0 and
    # does not apply, as the reference's jnp.argmax does
    slot = torch.where(has, match.to(torch.int8).argmax(1),
                       empty.to(torch.int8).argmax(1))
    ok = has | empty.any(1)
    cnt = torch.where(has, vc_row.gather(1, slot[:, None])[:, 0],
                      torch.zeros_like(d))
    newc = torch.clamp(cnt + d, min=0)
    applied = apply_i & ok
    hit = applied[:, None] & (torch.arange(H, device=slot.device)[None, :]
                              == slot[:, None])
    vk2 = torch.where(hit, val[:, None], vk_row)
    vc2 = torch.where(hit, newc[:, None], vc_row)
    return vk2, vc2, applied, apply_i & ~ok


def distinct_scan_plain(vk, vc, stamp, g, v, delta, part, ep, set_in=None,
                        set_in_m=None, emit_set=False):
    """The scan in plain torch ops: rows are stably ordered by group and
    ranked within it, and round r processes the r-th row of every group
    at once over gathered ``[G_r, H]`` tables. Rounds = rows of the
    largest group (one per row without ``group by``). Returns ``(nd,
    snap_vk, snap_live, overflow)``; the snapshots are None unless
    ``emit_set``."""
    _check(vk, vc, stamp, g, v, delta, part, ep, set_in, set_in_m)
    K, H = vk.shape
    R = g.shape[0]
    dev = vk.device
    nd = torch.zeros(R, dtype=torch.int64, device=dev)
    snap_vk = torch.zeros((R, H), dtype=torch.int64, device=dev) if emit_set else None
    snap_live = torch.zeros((R, H), dtype=torch.bool, device=dev) if emit_set else None
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if R == 0:
        return nd, snap_vk, snap_live, overflow
    order = torch.argsort(g, stable=True)
    gs = g[order]
    first = torch.searchsorted(gs, gs)              # each row's group start
    rank = torch.arange(R, device=dev) - first
    by_rank = order[torch.argsort(rank, stable=True)]
    bounds = [0] + torch.cumsum(torch.bincount(rank), 0).tolist()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows = by_rank[lo:hi]                       # one row per group
        gi = g[rows]
        vk_row = vk[gi]
        vc_orig = vc[gi]
        fresh = stamp[gi] != ep[rows]
        vc_row = torch.where(fresh[:, None], torch.full_like(vc_orig, -1), vc_orig)
        d, p = delta[rows], part[rows]
        if set_in is None:
            vk2, vc2, any_ap, ofl = _insert(vk_row, vc_row, v[rows], d, p)
        else:
            vk2, vc2 = vk_row, vc_row
            any_ap = torch.zeros_like(p)
            ofl = torch.zeros_like(p)
            for c in range(set_in.shape[1]):
                vk2, vc2, ap, o = _insert(vk2, vc2, set_in[rows, c], d,
                                          p & set_in_m[rows, c])
                any_ap, ofl = any_ap | ap, ofl | o
        ap2 = any_ap[:, None]
        vk[gi] = torch.where(ap2, vk2, vk_row)
        vc[gi] = torch.where(ap2, vc2, vc_orig)
        stamp[gi] = torch.where(any_ap, ep[rows], stamp[gi])
        live = torch.where(ap2, vc2, vc_row) > 0
        nd[rows] = live.sum(1)
        if emit_set:
            snap_vk[rows] = torch.where(ap2, vk2, vk_row)
            snap_live[rows] = live
        overflow |= ofl.any()
    return nd, snap_vk, snap_live, overflow


class _ScanArgs(ctypes.Structure):
    """The kernel's argument block (``ScanArgs`` in the source)."""

    _fields_ = [("vk", ctypes.c_void_p), ("vc", ctypes.c_void_p),
                ("stamp", ctypes.c_void_p), ("K", ctypes.c_longlong),
                ("H", ctypes.c_longlong), ("R", ctypes.c_longlong),
                ("gs", ctypes.c_void_p), ("order", ctypes.c_void_p),
                ("offsets", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("delta", ctypes.c_void_p), ("part", ctypes.c_void_p),
                ("ep", ctypes.c_void_p), ("set_in", ctypes.c_void_p),
                ("set_in_m", ctypes.c_void_p), ("cin", ctypes.c_longlong),
                ("nd", ctypes.c_void_p), ("snap_vk", ctypes.c_void_p),
                ("snap_live", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
                ("path", ctypes.c_longlong), ("workspace", ctypes.c_void_p),
                ("ws_blocks", ctypes.c_longlong)]


def _bind(lib) -> None:
    fn = lib.siddhi_distinct_scan
    fn.restype = ctypes.c_int
    # the stream as c_void_p: a plain int would be cut to 32 bits
    fn.argtypes = [ctypes.POINTER(_ScanArgs), ctypes.c_void_p]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def kernel_path(H: int) -> int:
    """The kernel's design for tables of ``H`` slots: ``PATH_REGISTERS``
    up to ``SMALL_MAX_H``, ``PATH_HASH`` up to ``MAX_H``, ``PATH_WIDE``
    above. Raises ``ValueError`` from ``WIDE_MAX_H`` on."""
    if not 1 <= H < WIDE_MAX_H:
        raise ValueError(
            f"distinct_scan: the CUDA kernel takes 1 <= H < {WIDE_MAX_H} value "
            f"slots per group, got {H}: set app_context.distinct_values_capacity "
            f"below {WIDE_MAX_H}")
    if H <= SMALL_MAX_H:
        return PATH_REGISTERS
    return PATH_HASH if H <= MAX_H else PATH_WIDE


def wide_workspace(K: int, H: int, device) -> Tuple[torch.Tensor, int]:
    """The global-index path's workspace: one slice of the free-slot bitmap
    (ceil(H / 32) words) and the hash index (the power of two >= 2H
    entries) per resident block, and the block count (at most K). Raises,
    naming the capacity knob, when the card cannot hold it."""
    ne = 32
    while ne < 2 * H:
        ne *= 2
    words = (H + 31) // 32 + ne
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, min(K, WIDE_BLOCKS_PER_SM * sms))
    try:
        ws = torch.empty(blocks * words, dtype=torch.int32, device=device)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"distinct_scan: no room for the {blocks * words * 4} byte index "
            f"workspace of H = {H} value slots; lower "
            f"app_context.distinct_values_capacity") from e
    return ws, blocks


def distinct_scan(vk, vc, stamp, g, v, delta, part, ep, set_in=None,
                  set_in_m=None, emit_set=False) -> Tuple:
    """Run the scan over one batch (see the module doc), updating ``vk``,
    ``vc`` and ``stamp`` in place. ``g`` holds group ids in [0, K).
    Returns ``(nd [R] int64, snap_vk [R, H] int64 | None, snap_live
    [R, H] bool | None, overflow 0-d bool)``."""
    device = vk.device
    if device.type == "cpu":
        return distinct_scan_plain(vk, vc, stamp, g, v, delta, part, ep,
                                   set_in, set_in_m, emit_set)
    if device.type != "cuda":
        raise ValueError(f"distinct_scan: unsupported device {device}")
    _check(vk, vc, stamp, g, v, delta, part, ep, set_in, set_in_m)
    return launch(vk, vc, stamp, g, v, delta, part, ep, set_in, set_in_m,
                  emit_set, kernel_path(vk.shape[1]))


def launch(vk, vc, stamp, g, v, delta, part, ep, set_in, set_in_m, emit_set,
           path: int) -> Tuple:
    """One launch of the kernel's ``path`` on checked CUDA tensors (what
    ``distinct_scan`` does once it has chosen the path)."""
    device = vk.device
    K, H = vk.shape
    R = g.shape[0]
    # one allocation: the counts, then each group's range of sorted rows
    scratch = torch.empty(R + K + 1, dtype=torch.int64, device=device)
    nd = scratch[:R]
    snap_vk = torch.empty((R, H), dtype=torch.int64, device=device) if emit_set else None
    snap_live = torch.empty((R, H), dtype=torch.bool, device=device) if emit_set else None
    if R == 0:
        return nd, snap_vk, snap_live, torch.zeros((), dtype=torch.bool, device=device)
    overflow = torch.empty((), dtype=torch.bool, device=device)   # cleared by the launch
    lib = _cuda.load("distinct_scan", _bind)
    v, delta, part, ep = (t.contiguous() for t in (v, delta, part, ep))
    if set_in is not None:
        set_in, set_in_m = set_in.contiguous(), set_in_m.contiguous()
    # rows in group order (stable, so arrival order within a group); the
    # kernel reads every row input through ``order``
    gs, order = torch.sort(g, stable=True)
    ws, ws_blocks = (wide_workspace(K, H, device) if path == PATH_WIDE
                     else (None, 0))
    args = _ScanArgs(
        _ptr(vk), _ptr(vc), _ptr(stamp), K, H, R, _ptr(gs), _ptr(order),
        _ptr(scratch) + 8 * R, _ptr(v if set_in is None else None), _ptr(delta),
        _ptr(part), _ptr(ep), _ptr(set_in), _ptr(set_in_m),
        0 if set_in is None else set_in.shape[1], _ptr(nd), _ptr(snap_vk),
        _ptr(snap_live), _ptr(overflow), path, _ptr(ws), ws_blocks)
    guard = (torch.cuda.device(device) if device.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.siddhi_distinct_scan(ctypes.byref(args), stream)
    _cuda.check(lib, code, "distinct_scan launch")
    _cuda.count(distinct_scan)
    return nd, snap_vk, snap_live, overflow


distinct_scan.launches = 0
