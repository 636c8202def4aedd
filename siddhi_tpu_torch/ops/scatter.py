"""In-place masked scatter for state tensors.

The reference rebuilds each state buffer every step
(``buf.at[slot].set(v, mode="drop")`` under a donated jit), which is where
XLA's copy insertion could double a large ring per step. The port updates
window rings and aggregator state in place instead, so a step never copies
a state buffer; that is why it has no copy-insertion cliff.

A scatter whose rows are masked ("drop" rows) must not sync the host to
compact the kept indices. Instead every dropped row is redirected to ONE
anchor write: the first kept row's index and value, or, when no row is
kept, index 0 with the value already stored there. All writes to a
duplicated index then carry identical values, so the result does not
depend on the order the device applies them in.
"""

from __future__ import annotations

import torch


def put_where_(dst: torch.Tensor, dim: int, idx: torch.Tensor,
               src: torch.Tensor, keep: torch.Tensor) -> None:
    """``dst.index_copy_(dim, idx[keep], src[keep])`` without a host sync.

    ``idx``/``keep`` are ``[B]``; ``src`` has ``dst``'s shape with
    ``dst.shape[dim]`` replaced by ``B``. Kept indices must be unique."""
    B = idx.shape[0]
    if B == 0:
        return
    src = src.to(dst.dtype)
    any_keep = keep.any()
    # first kept row (0 if none), as a [1] index: indexing with a 0-d
    # tensor would read it back to the host
    anchor = torch.argmax(keep.to(torch.int8)).view(1)
    anchor_idx = torch.where(any_keep, idx[anchor], torch.zeros_like(idx[anchor]))
    src_m = src.movedim(dim, 0)                     # [B, ...]
    stored = dst.movedim(dim, 0)[:1]                # value at index 0, pre-write
    anchor_val = torch.where(any_keep, src_m[anchor], stored)
    shape = (B,) + (1,) * (src_m.dim() - 1)
    val = torch.where(keep.view(shape), src_m, anchor_val)
    tgt = torch.where(keep, idx, anchor_idx).to(torch.int64)
    dst.index_copy_(dim, tgt, val.movedim(0, dim))
