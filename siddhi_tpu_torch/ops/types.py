"""Type system: Siddhi attribute types -> numpy and torch dtypes.

Counterpart of ``siddhi_tpu/ops/types.py``. Host batches stay numpy (the
dictionary encoder, keyers and decoders are numpy code); device columns
and state are torch tensors of the matching dtype. Longs and timestamps
are ``torch.int64`` on every device, the width the reference runs under
``jax_enable_x64``.

Java semantics preserved:
- numeric promotion int < long < float < double;
- ``/`` on int/long truncates toward zero;
- ``%`` takes the sign of the dividend;
- strings are dictionary ids, only ``==``/``!=`` compare them.
"""

from __future__ import annotations

import numpy as np
import torch

from siddhi_tpu_torch.query_api.definitions import AttrType

# STRING columns are dictionary-encoded int32 ids (host-side dictionary).
DTYPES = {
    AttrType.STRING: np.int32,
    AttrType.INT: np.int32,
    AttrType.LONG: np.int64,
    AttrType.FLOAT: np.float32,
    AttrType.DOUBLE: np.float64,
    AttrType.BOOL: np.bool_,
    AttrType.OBJECT: np.int64,
}

TORCH_OF_NUMPY = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.bool_): torch.bool,
}
TORCH_TO_NUMPY = {t: n for n, t in TORCH_OF_NUMPY.items()}

_NUMERIC_ORDER = [AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE]


def dtype_of(t: AttrType):
    """numpy dtype of an attribute type (host columns)."""
    return DTYPES[t]


def torch_dtype_of(t: AttrType) -> torch.dtype:
    """torch dtype of an attribute type (device columns and state)."""
    return TORCH_OF_NUMPY[np.dtype(DTYPES[t])]


def to_torch_dtype(dt) -> torch.dtype:
    """numpy dtype (or type) -> torch dtype; torch dtypes pass through."""
    if isinstance(dt, torch.dtype):
        return dt
    return TORCH_OF_NUMPY[np.dtype(dt)]


def is_numeric(t: AttrType) -> bool:
    return t in _NUMERIC_ORDER


def promote(a: AttrType, b: AttrType) -> AttrType:
    """Java binary numeric promotion."""
    if not is_numeric(a) or not is_numeric(b):
        raise TypeError(f"cannot apply arithmetic to {a} and {b}")
    return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a), _NUMERIC_ORDER.index(b))]


def saturating_int(v, dtype):
    """Float -> integer conversion with Java's ``(int)``/``(long)`` cast
    semantics, for torch tensors and numpy arrays alike: NaN becomes 0,
    values at or beyond the integer range clamp to its MIN/MAX, the rest
    truncate toward zero. A bare ``.to(int)`` leaves NaN, infinities and
    out-of-range values undefined (INT_MIN on a CPU)."""
    if isinstance(v, torch.Tensor):
        info = torch.iinfo(dtype)
        v = v.to(torch.float64)
        # float(info.max) rounds up to 2**63 for int64: >= catches it
        hi, lo = v >= float(info.max), v <= float(info.min)
        out = torch.where(hi | lo | torch.isnan(v), 0.0, v).to(dtype)
        return torch.where(hi, info.max, torch.where(lo, info.min, out))
    info = np.iinfo(dtype)
    v = np.asarray(v, np.float64)
    hi, lo = v >= float(info.max), v <= float(info.min)
    out = np.where(hi | lo | np.isnan(v), 0.0, v).astype(dtype)
    return np.where(hi, info.max, np.where(lo, info.min, out)).astype(dtype)


def java_div(xp, a, b, t: AttrType):
    """Division with Java semantics for the promoted type ``t``."""
    if t in (AttrType.FLOAT, AttrType.DOUBLE):
        return a / b
    # int/long: truncate toward zero (floor division floors, Java truncates).
    # A zero divisor yields 0 (the reference's result) instead of raising:
    # batch padding rows hold zeros, so it occurs in almost every batch
    zero = b == 0
    q = xp.abs(a) // xp.abs(xp.where(zero, 1, b))
    return xp.astype(xp.where(zero, 0, xp.sign(a) * xp.sign(b) * q), t)


def java_mod(xp, a, b, t: AttrType):
    """% with Java semantics (sign of the dividend)."""
    if t in (AttrType.FLOAT, AttrType.DOUBLE):
        return xp.fmod(a, b)
    zero = b == 0
    r = xp.abs(a) % xp.abs(xp.where(zero, 1, b))
    return xp.astype(xp.where(zero, 0, xp.sign(a) * r), t)
