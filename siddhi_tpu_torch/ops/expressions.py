"""Expression compiler: query-api expression AST -> columnar functions.

Counterpart of ``siddhi_tpu/ops/expressions.py``: constants, attribute
reads, arithmetic, comparisons, ``and``/``or``/``not``, ``is null`` and
the function library (``cast``/``convert``, ``ifThenElse``, ``coalesce``,
``default``, ``maximum``/``minimum``, ``instanceOf*``,
``eventTimestamp``, ``currentTimeMillis``, ``uuid``, ``createSet``,
``sizeOfSet``, ``log`` and registered extension functions). ``in
<table>`` waits for tables and raises ``CompileError``.

A compiled node is ``fn(cols, ctx) -> (value, null_mask_or_None)``. The
reference hands the node an array namespace in ``ctx["xp"]`` (``jnp`` on
device, ``np`` on host); here ``ctx["xp"]`` is a small shim with the
numpy-named calls the nodes, extension functions and script bodies use:
:class:`TorchXP` over tensors on one device, :data:`NUMPY_XP` over host
arrays (the keyers evaluate key expressions on host batches).

Null semantics follow the reference executors: comparisons with a null
operand are false, arithmetic with a null operand is null, and/or treat
null conditions as false; ``isNull``/``coalesce``/``default`` observe
nullness.

Set values (OBJECT attributes) share one element encoding with the
distinctCount/unionSet value tables: every element is an int64 identity
code (strings their dictionary id, floats their bit pattern).
"""

from __future__ import annotations

import threading
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
    """Array namespace over torch tensors on one device.

    Besides ``astype(v, AttrType)`` and ``zeros_bool(shape)``, which the
    compiled nodes use, it offers the numpy-named calls an extension
    function or a ``define function`` script body reasonably uses:
    ``asarray``, ``where``, ``maximum``, ``minimum``, ``sqrt``, ``abs``,
    ``sign``, ``fmod``, ``sum(v, axis=None, dtype=None)``, ``zeros``,
    ``ones``, ``full``, ``zeros_like``, ``ones_like`` and the dtypes
    ``int32``, ``int64``, ``float32``, ``float64``, ``bool_``. Their
    arguments may be tensors, numpy values or Python scalars; results are
    tensors on the namespace's device."""

    int32, int64 = torch.int32, torch.int64
    float32, float64 = torch.float32, torch.float64
    bool_ = torch.bool

    def __init__(self, device):
        self.device = torch.device(device)

    def asarray(self, v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(np.asarray(v), device=self.device)

    def astype(self, v, t: AttrType):
        v = self.asarray(v)
        dt = T.torch_dtype_of(t)
        if v.is_floating_point() and not dt.is_floating_point and dt != torch.bool:
            return T.saturating_int(v, dt)
        return v.to(dt)

    def zeros_bool(self, shape):
        return torch.zeros(shape, dtype=torch.bool, device=self.device)

    def where(self, c, a, b):
        return torch.where(self.asarray(c), self.asarray(a), self.asarray(b))

    def maximum(self, a, b):
        return torch.maximum(self.asarray(a), self.asarray(b))

    def minimum(self, a, b):
        return torch.minimum(self.asarray(a), self.asarray(b))

    def sqrt(self, v):
        return torch.sqrt(self.asarray(v))

    def abs(self, v):
        return torch.abs(self.asarray(v))

    def sign(self, v):
        return torch.sign(self.asarray(v))

    def fmod(self, a, b):
        return torch.fmod(self.asarray(a), self.asarray(b))

    def sum(self, v, axis=None, dtype=None):
        v = self.asarray(v)
        if axis is None:
            return torch.sum(v, dtype=dtype)
        return torch.sum(v, dim=axis, dtype=dtype)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=dtype, device=self.device)

    def full(self, shape, value, dtype=None):
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def zeros_like(self, v, dtype=None):
        return torch.zeros_like(self.asarray(v), dtype=dtype)

    def ones_like(self, v, dtype=None):
        return torch.ones_like(self.asarray(v), dtype=dtype)


class _NumpyXP:
    """Array namespace over host numpy arrays (keyers, host filters), with
    the calls of :class:`TorchXP`."""

    int32, int64 = np.int32, np.int64
    float32, float64 = np.float32, np.float64
    bool_ = np.bool_
    asarray = staticmethod(np.asarray)
    where = staticmethod(np.where)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)
    sqrt = staticmethod(np.sqrt)
    abs = staticmethod(np.abs)
    sign = staticmethod(np.sign)
    fmod = staticmethod(np.fmod)
    sum = staticmethod(np.sum)
    zeros = staticmethod(np.zeros)
    ones = staticmethod(np.ones)
    full = staticmethod(np.full)
    zeros_like = staticmethod(np.zeros_like)
    ones_like = staticmethod(np.ones_like)

    @staticmethod
    def astype(v, t: AttrType):
        v = np.asarray(v)
        dt = np.dtype(T.dtype_of(t))
        if v.dtype.kind == "f" and dt.kind in "iu":
            return T.saturating_int(v, dt)
        return v.astype(dt)

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
        return _compile_function(expr, resolver)
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


# ------------------------------------------------------------- functions

_TYPE_NAMES = {
    "string": AttrType.STRING,
    "int": AttrType.INT,
    "long": AttrType.LONG,
    "float": AttrType.FLOAT,
    "double": AttrType.DOUBLE,
    "bool": AttrType.BOOL,
}

_INSTANCE_OF = {
    "instanceofboolean": AttrType.BOOL, "instanceofstring": AttrType.STRING,
    "instanceofinteger": AttrType.INT, "instanceoflong": AttrType.LONG,
    "instanceoffloat": AttrType.FLOAT, "instanceofdouble": AttrType.DOUBLE,
}


def _mask(xp, m):
    """A null mask as the namespace's array (a typed null literal's mask
    is a numpy scalar)."""
    return None if m is None else xp.asarray(m)


def _compile_function(expr: AttributeFunction, resolver) -> Compiled:
    name = (f"{expr.namespace}:{expr.name}" if expr.namespace else expr.name).lower()
    args = expr.parameters

    if name in ("cast", "convert"):
        # cast(x, 'double') (reference Cast/ConvertFunctionExecutor)
        if len(args) != 2:
            raise CompileError(
                f"{name}() needs exactly (value, '<type>'), got {len(args)} "
                f"arguments")
        src_f, src_t = compile_expr(args[0], resolver)
        if not isinstance(args[1], Constant) or args[1].type != AttrType.STRING:
            raise CompileError(f"{name}() target type must be a string constant")
        if args[1].value.lower() not in _TYPE_NAMES:
            raise CompileError(
                f"{name}() target '{args[1].value}' is not a type name")
        target = _TYPE_NAMES[args[1].value.lower()]
        if AttrType.STRING in (src_t, target) and src_t != target:
            # the reference's planner rewrites these into host parse and
            # format stages (query_planner._rewrite_string_casts)
            raise CompileError(
                f"{name}() between string and {src_t if target == AttrType.STRING else target}"
                f" runs host-side and is not ported to siddhi_tpu_torch yet")

        if target == AttrType.BOOL and src_t != AttrType.BOOL:
            # numeric -> bool is `value == 1` (ConvertFunctionExecutor:
            # 2f converts to false, 1f to true)
            def fn(cols, ctx):
                v, m = src_f(cols, ctx)
                return ctx["xp"].asarray(v) == 1, m
        else:
            def fn(cols, ctx):
                v, m = src_f(cols, ctx)
                return ctx["xp"].astype(v, target), m

        return fn, target

    if name == "ifthenelse":
        cond_f = compile_condition(args[0], resolver)
        then_f, then_t = compile_expr(args[1], resolver)
        else_f, else_t = compile_expr(args[2], resolver)
        out_t = then_t if then_t == else_t else T.promote(then_t, else_t)

        def fn(cols, ctx):
            xp = ctx["xp"]
            c = xp.asarray(cond_f(cols, ctx))
            tv, tm = then_f(cols, ctx)
            ev, em = else_f(cols, ctx)
            v = xp.where(c, xp.astype(tv, out_t), xp.astype(ev, out_t))
            if tm is None and em is None:
                return v, None
            zeros = xp.zeros_bool(_shape_of(v, cols))
            m = xp.where(c, zeros if tm is None else tm,
                         zeros if em is None else em)
            return v, m

        return fn, out_t

    if name == "coalesce":
        compiled = [compile_expr(a, resolver) for a in args]
        out_t = compiled[0][1]
        for _, t in compiled[1:]:
            if t != out_t:
                raise CompileError("coalesce() arguments must share one type")

        def fn(cols, ctx):
            xp = ctx["xp"]
            v, m = compiled[0][0](cols, ctx)
            v = xp.astype(v, out_t)
            m = _mask(xp, m)
            if m is None:
                return v, None
            for f, _t in compiled[1:]:
                nv, nm = f(cols, ctx)
                v = xp.where(m, xp.astype(nv, out_t), v)
                if nm is None:
                    m = xp.zeros_like(m)
                    break
                m = m & xp.asarray(nm)
            return v, m

        return fn, out_t

    if name == "default":
        if len(args) != 2:
            raise CompileError(
                f"default() needs exactly (attribute, value), got "
                f"{len(args)} arguments")
        src_f, src_t = compile_expr(args[0], resolver)
        dft_f, dft_t = compile_expr(args[1], resolver)
        if src_t != dft_t:
            raise CompileError("default() value type must match attribute type")

        def fn(cols, ctx):
            xp = ctx["xp"]
            v, m = src_f(cols, ctx)
            if m is None:
                return v, None
            dv, _dm = dft_f(cols, ctx)
            return xp.where(m, xp.astype(dv, src_t), xp.astype(v, src_t)), None

        return fn, src_t

    if name in ("maximum", "minimum"):
        compiled = [compile_expr(a, resolver) for a in args]
        out_t = compiled[0][1]
        for _, t in compiled[1:]:
            out_t = T.promote(out_t, t)
        is_max = name == "maximum"

        def fn(cols, ctx):
            xp = ctx["xp"]
            v, m = compiled[0][0](cols, ctx)
            v = xp.astype(v, out_t)
            for f, _t in compiled[1:]:
                nv, nm = f(cols, ctx)
                nv = xp.astype(nv, out_t)
                v = xp.maximum(v, nv) if is_max else xp.minimum(v, nv)
                m = _or_masks(m, nm)
            return v, m

        return fn, out_t

    if name.startswith("instanceof"):
        if name not in _INSTANCE_OF:
            raise CompileError(f"unknown function '{name}'")
        target = _INSTANCE_OF[name]
        src_f, src_t = compile_expr(args[0], resolver)
        matches = src_t == target

        def fn(cols, ctx):
            xp = ctx["xp"]
            v, m = src_f(cols, ctx)
            res = xp.full(_shape_of(v, cols), matches, dtype=xp.bool_)
            if m is not None:
                res = res & ~xp.asarray(m)   # null is an instance of nothing
            return res, None

        return fn, AttrType.BOOL

    if name == "eventtimestamp":
        if args:
            raise CompileError(
                f"eventTimestamp() takes no arguments, got {len(args)}")

        def fn(cols, ctx):
            return cols[TS_KEY], None

        return fn, AttrType.LONG

    if name == "currenttimemillis":
        def fn(cols, ctx):
            # the runtime hands each step the batch-receive wall time
            return ctx["current_time"], None

        return fn, AttrType.LONG

    if name == "uuid":
        # reference UUIDFunctionExecutor: a fresh UUID string per event.
        # String columns are dictionary ids, so the step emits a
        # placeholder and the output column is flagged for a host-side
        # fill after the step (QueryRuntime._emit)
        mark_uuid_seen()

        def fn(cols, ctx):
            return ctx["xp"].zeros(_shape_of(None, cols),
                                   dtype=ctx["xp"].int32), None

        return fn, AttrType.STRING

    if name == "createset":
        # reference CreateSetFunctionExecutor: a singleton set, which
        # travels as its element's int64 identity code (a scalar column
        # that windows buffer as they are); multi-element sets only arise
        # as unionSet outputs
        if len(args) != 1:
            raise CompileError(
                "createSet() function has to have exactly 1 parameter, "
                f"currently {len(args)} parameters provided")
        src_f, src_t = compile_expr(args[0], resolver)
        if src_t == AttrType.OBJECT:
            raise CompileError("createSet() argument must be a primitive type")
        mark_object_elem(src_t)

        def fn(cols, ctx):
            v, m = src_f(cols, ctx)
            return _encode_set_element(ctx["xp"], v, src_t), m

        return fn, AttrType.OBJECT

    if name == "sizeofset":
        # reference SizeOfSetFunctionExecutor. A unionSet output carries
        # its live count in the base column and its elements in
        # '#set'/'#setm' companions; a createSet singleton is size 1, or 0
        # when null
        if len(args) != 1 or not isinstance(args[0], Variable):
            raise CompileError(
                "sizeOfSet() expects exactly one set-typed attribute reference")
        ref = resolver.resolve(args[0])
        if ref.type != AttrType.OBJECT:
            raise CompileError(
                f"sizeOfSet() argument must be of type object, "
                f"found {ref.type.value}")
        key = ref.key
        defn = getattr(resolver, "definition", None)
        multi = key in (getattr(defn, "object_multi_attrs", None) or set())

        def fn(cols, ctx):
            xp = ctx["xp"]
            sm = cols.get(key + "#setm")
            if sm is not None:      # multi-element set: count live slots
                return xp.sum(sm, axis=-1, dtype=xp.int64), None
            if multi:               # companions dropped: the count stands
                return xp.astype(cols[key], AttrType.LONG), None
            one = xp.ones_like(cols[key], dtype=xp.int64)
            m = cols.get(key + "?")
            if m is None:
                return one, None
            return xp.where(m, xp.zeros_like(one), one), None

        return fn, AttrType.INT

    if name == "log":
        # reference LogFunctionExecutor: logs its arguments per event and
        # passes true. Printing reads the values back to the host, a sync
        # per batch that only this debug function pays
        compiled = [compile_expr(a, resolver) for a in args]

        def fn(cols, ctx):
            xp = ctx["xp"]
            vals = [f(cols, ctx)[0] for f, _t in compiled]
            print("siddhi:", *[np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                          else v) for v in vals])
            return xp.ones(_shape_of(vals[0] if vals else None, cols),
                           dtype=xp.bool_), None

        return fn, AttrType.BOOL

    ext = resolve_extension("function", name)
    if ext is not None:
        # custom scalar function (reference SiddhiExtensionLoader resolving
        # FunctionExecutor @Extension classes), vectorized over columns
        compiled = [compile_expr(a, resolver) for a in args]
        out_t = ext.return_type
        if callable(out_t):
            out_t = out_t([t for _, t in compiled])

        def fn(cols, ctx):
            vals, m = [], None
            for f, _t in compiled:
                v, vm = f(cols, ctx)
                vals.append(v)
                m = _or_masks(m, vm)
            return ext.apply(ctx["xp"], *vals), m

        return fn, out_t

    raise CompileError(f"unknown function '{name}'")


# ------------------------------------------------------- extensions, sets

# The extension registry active during query compilation: every compile
# entry point (app construction) points it at its SiddhiContext.extensions
# merged with the app's `define function` scripts, the role of reference
# SiddhiExtensionLoader.java:58-98. Thread-local, so two managers
# compiling at once never see each other's registries; so are the markers
# a compiled uuid()/createSet() leaves for the selector planner.
_ACTIVE = threading.local()
_UUID_MARK = threading.local()
_OBJ_MARK = threading.local()


def mark_uuid_seen():
    _UUID_MARK.flag = True


def take_uuid_marker() -> bool:
    """True if a uuid() call was compiled since the last take (consumed by
    plan_selector to flag the output column for host fill)."""
    flag = getattr(_UUID_MARK, "flag", False)
    _UUID_MARK.flag = False
    return flag


def mark_object_elem(elem_type):
    _OBJ_MARK.elem = elem_type


def take_object_elem_marker():
    """Element type of the set produced by a createSet() compiled since the
    last take (consumed by plan_selector to record decode metadata)."""
    elem = getattr(_OBJ_MARK, "elem", None)
    _OBJ_MARK.elem = None
    return elem


def _encode_set_element(xp, v, elem_type):
    """Value column -> int64 set-element identity codes (shared with the
    distinctCount/unionSet value tables): floats by bit pattern (so -0.0
    and 0.0 differ), strings already dictionary ids."""
    v = xp.asarray(v)
    if isinstance(v, torch.Tensor):
        if elem_type == AttrType.FLOAT:
            v = v.to(torch.float32).view(torch.int32)
        elif elem_type == AttrType.DOUBLE:
            v = v.to(torch.float64).view(torch.int64)
        return v.to(torch.int64)
    if elem_type == AttrType.FLOAT:
        v = v.astype(np.float32).view(np.int32)
    elif elem_type == AttrType.DOUBLE:
        v = v.astype(np.float64).view(np.int64)
    return v.astype(np.int64)


def encode_set_value(val, elem_type, dictionary) -> int:
    """Host-side inverse of ``decode_set_element`` for Event ingestion:
    one Python element to its int64 identity code, honouring the stream's
    recorded element type (FLOAT -> float32 bit pattern, DOUBLE ->
    float64), as ``_encode_set_element`` encodes on the device."""
    if isinstance(val, str):
        return int(dictionary.encode(val))
    if isinstance(val, bool):
        return int(val)
    if isinstance(val, float):
        if elem_type == AttrType.FLOAT:
            return int(np.float32(val).view(np.int32))
        return int(np.float64(val).view(np.int64))
    return int(val)


def decode_set_element(code: int, elem_type, dictionary):
    """Inverse of ``_encode_set_element`` for host-side event decode."""
    if elem_type == AttrType.STRING:
        return dictionary.decode(int(code))
    if elem_type == AttrType.FLOAT:
        return float(np.int32(code).view(np.float32))
    if elem_type == AttrType.DOUBLE:
        return float(np.int64(code).view(np.float64))
    if elem_type == AttrType.BOOL:
        return bool(code)
    return int(code)


def set_active_extensions(extensions: dict) -> None:
    _ACTIVE.extensions = extensions if extensions is not None else {}


def resolve_in(extensions: dict, kind: str, name: str):
    """Shared 'kind:name, then bare name, case-insensitive' lookup rule."""
    for key in (f"{kind}:{name}", name):
        cls = extensions.get(key) or extensions.get(key.lower())
        if cls is not None:
            return cls
    return None


def resolve_extension(kind: str, name: str):
    return resolve_in(getattr(_ACTIVE, "extensions", {}), kind, name)
