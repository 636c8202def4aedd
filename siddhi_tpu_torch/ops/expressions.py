"""Expression compiler: query-api expression AST -> columnar functions.

Counterpart of ``siddhi_tpu/ops/expressions.py``, holding the subset the
port's selector, filters and keyers need: constants, attribute reads,
arithmetic, comparisons, ``and``/``or``/``not`` and ``is null``. Function
calls (``cast``, ``coalesce``, extensions...) wait for a later slice and
raise ``CompileError`` naming themselves.

A compiled node is ``fn(cols, ctx) -> (value, null_mask_or_None)``. The
reference hands the node an array namespace in ``ctx["xp"]`` (``jnp`` on
device, ``np`` on host); here ``ctx["xp"]`` is a small shim with one method
per operation the nodes use: :class:`TorchXP` over tensors on one device,
:data:`NUMPY_XP` over host arrays (the keyers evaluate key expressions on
host batches).

Null semantics follow the reference executors: comparisons with a null
operand are false, arithmetic with a null operand is null, and/or treat
null conditions as false.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.ops import types as T
from siddhi_tpu_torch.query_api.definitions import AttrType
from siddhi_tpu_torch.query_api.expressions import (
    Add,
    And,
    AttributeFunction,
    Compare,
    Constant,
    Divide,
    Expression,
    InOp,
    IsNull,
    Mod,
    Multiply,
    Not,
    Or,
    Subtract,
    TimeConstant,
    Variable,
)

# Reserved column keys present in every device batch.
TS_KEY = "__ts__"
TYPE_KEY = "__type__"
VALID_KEY = "__valid__"
PK_KEY = "__pk__"  # partition-key id column (dense, host-computed)
# Device-routed sharding (parallel/mesh.device_route_query_step): RIDX_KEY
# is a row's position in the ORIGINAL unrouted batch, attached before the
# shard exchange; window stages derive their emission-order keys from it
# (OKEY_KEY) so routed output re-merges into the exact unrouted order.
RIDX_KEY = "__ridx__"
OKEY_KEY = "__okey__"


class TorchXP:
    """Array namespace over torch tensors on one device."""

    def __init__(self, device):
        self.device = torch.device(device)

    def asarray(self, v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(np.asarray(v), device=self.device)

    def astype(self, v, t: AttrType):
        return self.asarray(v).to(T.torch_dtype_of(t))

    def zeros_bool(self, shape):
        return torch.zeros(shape, dtype=torch.bool, device=self.device)

    def abs(self, v):
        return torch.abs(v)

    def sign(self, v):
        return torch.sign(v)

    def fmod(self, a, b):
        return torch.fmod(a, b)


class _NumpyXP:
    """Array namespace over host numpy arrays (keyers, host filters)."""

    asarray = staticmethod(np.asarray)
    abs = staticmethod(np.abs)
    sign = staticmethod(np.sign)
    fmod = staticmethod(np.fmod)

    @staticmethod
    def astype(v, t: AttrType):
        return np.asarray(v).astype(T.dtype_of(t))

    @staticmethod
    def zeros_bool(shape):
        return np.zeros(shape, dtype=bool)


NUMPY_XP = _NumpyXP()


@dataclass
class ColumnRef:
    key: str
    type: AttrType


class Resolver:
    """Maps Variables to batch columns (query planners subclass this)."""

    def resolve(self, var: Variable) -> ColumnRef:
        raise NotImplementedError

    def encode_string(self, s: str) -> int:
        raise NotImplementedError


class CompileError(Exception):
    pass


Compiled = Tuple[Callable, AttrType]


def _const(value, attr_type: AttrType) -> Compiled:
    def fn(cols, ctx):
        return value, None

    return fn, attr_type


def compile_expr(expr: Expression, resolver: Resolver) -> Compiled:
    """Lower ``expr``; returns (fn, result_type)."""
    if isinstance(expr, Constant):
        if expr.value is None:
            zero = (np.int32(0) if expr.type == AttrType.STRING
                    else np.zeros((), T.dtype_of(expr.type))[()])

            def null_fn(cols, ctx, _z=zero):
                return _z, np.True_

            return null_fn, expr.type
        if expr.type == AttrType.STRING:
            return _const(np.int32(resolver.encode_string(expr.value)), AttrType.STRING)
        return _const(np.asarray(expr.value, dtype=T.dtype_of(expr.type))[()], expr.type)
    if isinstance(expr, TimeConstant):
        return _const(np.int64(expr.value), AttrType.LONG)
    if isinstance(expr, Variable):
        ref = resolver.resolve(expr)
        key, mask_key = ref.key, ref.key + "?"

        def fn(cols, ctx):
            return cols[key], cols.get(mask_key)

        return fn, ref.type
    if isinstance(expr, (Add, Subtract, Multiply, Divide, Mod)):
        return _compile_math(expr, resolver)
    if isinstance(expr, Compare):
        return _compile_compare(expr, resolver)
    if isinstance(expr, (And, Or)):
        lf, lt = compile_expr(expr.left, resolver)
        rf, rt = compile_expr(expr.right, resolver)
        _require_bool(lt, rt)
        is_and = isinstance(expr, And)

        def fn(cols, ctx):
            lv, lm = lf(cols, ctx)
            rv, rm = rf(cols, ctx)
            lv, rv = _false_if_null(lv, lm), _false_if_null(rv, rm)
            return (lv & rv) if is_and else (lv | rv), None

        return fn, AttrType.BOOL
    if isinstance(expr, Not):
        inner_f, inner_t = compile_expr(expr.expression, resolver)
        _require_bool(inner_t)

        def fn(cols, ctx):
            v, m = inner_f(cols, ctx)
            return ~_false_if_null(v, m), None

        return fn, AttrType.BOOL
    if isinstance(expr, IsNull):
        inner_f, _t = compile_expr(expr.expression, resolver)

        def fn(cols, ctx):
            v, m = inner_f(cols, ctx)
            if m is None:
                return ctx["xp"].zeros_bool(_shape_of(v, cols)), None
            return m, None

        return fn, AttrType.BOOL
    if isinstance(expr, AttributeFunction):
        name = f"{expr.namespace}:{expr.name}" if expr.namespace else expr.name
        raise CompileError(
            f"function '{name}()' is not ported to siddhi_tpu_torch yet")
    if isinstance(expr, InOp):
        raise CompileError("'in <table>' conditions are not ported yet")
    raise CompileError(f"cannot compile expression {expr!r}")


def compile_condition(expr: Expression, resolver: Resolver) -> Callable:
    """Boolean condition: fn(cols, ctx) -> bool array (nulls -> False)."""
    f, t = compile_expr(expr, resolver)
    if t != AttrType.BOOL:
        raise CompileError(f"filter condition must be bool, got {t}")

    def fn(cols, ctx):
        v, m = f(cols, ctx)
        return _false_if_null(v, m)

    return fn


def _shape_of(v, cols):
    shape = tuple(getattr(v, "shape", ()))
    if shape:
        return shape
    return tuple(cols[TS_KEY].shape)


def _false_if_null(value, mask):
    if mask is None:
        return value
    return value & ~mask


def _or_masks(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _require_bool(*ts: AttrType):
    for t in ts:
        if t != AttrType.BOOL:
            raise CompileError(f"expected bool operand, got {t}")


def _compile_math(expr, resolver) -> Compiled:
    lf, lt = compile_expr(expr.left, resolver)
    rf, rt = compile_expr(expr.right, resolver)
    out_t = T.promote(lt, rt)
    op = type(expr).__name__

    def fn(cols, ctx):
        xp = ctx["xp"]
        lv, lm = lf(cols, ctx)
        rv, rm = rf(cols, ctx)
        a = xp.astype(lv, out_t)
        b = xp.astype(rv, out_t)
        if op == "Add":
            v = a + b
        elif op == "Subtract":
            v = a - b
        elif op == "Multiply":
            v = a * b
        elif op == "Divide":
            v = T.java_div(xp, a, b, out_t)
        else:
            v = T.java_mod(xp, a, b, out_t)
        return v, _or_masks(lm, rm)

    return fn, out_t


def _compile_compare(expr: Compare, resolver) -> Compiled:
    lf, lt = compile_expr(expr.left, resolver)
    rf, rt = compile_expr(expr.right, resolver)
    op = expr.operator
    if AttrType.STRING in (lt, rt) or AttrType.BOOL in (lt, rt):
        # strings are dictionary ids: only ==/!= are defined
        if op not in ("==", "!=") or lt != rt:
            raise CompileError(f"'{op}' not defined between {lt} and {rt}")
        cmp_t = lt
    else:
        cmp_t = T.promote(lt, rt)

    def fn(cols, ctx):
        xp = ctx["xp"]
        lv, lm = lf(cols, ctx)
        rv, rm = rf(cols, ctx)
        lv, rv = xp.astype(lv, cmp_t), xp.astype(rv, cmp_t)
        if op == "<":
            v = lv < rv
        elif op == "<=":
            v = lv <= rv
        elif op == ">":
            v = lv > rv
        elif op == ">=":
            v = lv >= rv
        elif op == "==":
            v = lv == rv
        else:
            v = lv != rv
        # null comparison -> false (reference null guards return false)
        return _false_if_null(v, _or_masks(lm, rm)), None

    return fn, AttrType.BOOL
