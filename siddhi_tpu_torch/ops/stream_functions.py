"""Stream functions: ``#name(args)`` handlers.

Counterpart of ``siddhi_tpu/ops/stream_functions.py`` (reference
``StreamFunctionProcessor.java``, ``LogStreamProcessor.java``,
``Pol2CartStreamFunctionProcessor.java``): a stream function compiles to a
vectorized column transform in the query's step. A :class:`TransformStage`
appends synthetic columns (and their ``<name>?`` null masks) that later
filters, windows and selectors resolve like declared attributes; it runs
on the device (``ctx["xp"]`` a ``TorchXP``) or on the host with numpy
(``NUMPY_XP``: host windows, log taps, host transforms). A
:class:`LogStage` is a host pass-through tap.

The string<->number casts are host stages: ``StringParseCastStage`` maps
dictionary ids to parsed values through a lookup table grown per new
dictionary entry, ``NumericFormatCastStage`` formats a batch's unique
values once and dictionary-encodes them; the device sees the synthetic
column. Custom stream functions register through the extension SPI
(``set_extension("streamFunction:<name>", cls)``). ``<cond> in Table``
is ``InProbeStage``, a host stage over the table's contents.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Tuple

import numpy as np

from siddhi_tpu_torch.ops.expressions import (
    VALID_KEY,
    CompileError,
    compile_expr,
    resolve_extension,
)
from siddhi_tpu_torch.ops.types import dtype_of, is_numeric
from siddhi_tpu_torch.query_api.definitions import Attribute, AttrType
from siddhi_tpu_torch.query_api.expressions import Constant

logger = logging.getLogger("siddhi")


class TransformStage:
    """A pure row-wise column transform: ``apply(cols, ctx)`` returns the
    column dict extended with ``out_attrs`` value + null-mask columns.
    Runs inside the device step (``ctx["xp"]`` a ``TorchXP``) and equally
    on the host with ``NUMPY_XP`` (host windows, log taps)."""

    def __init__(self, out_attrs: List[Attribute], fn: Callable):
        # fn(cols, ctx) -> List[(name, values, null_mask)]
        self.out_attrs = out_attrs
        self._fn = fn

    def apply(self, cols: Dict, ctx: Dict) -> Dict:
        xp = ctx["xp"]
        cols = dict(cols)
        B = cols[VALID_KEY].shape[0]
        for name, v, m in self._fn(cols, ctx):
            cols[name] = xp.broadcast_to(xp.asarray(v), (B,))
            if m is None:
                m = xp.zeros_bool((B,))
            cols[name + "?"] = xp.broadcast_to(xp.asarray(m), (B,))
        return cols


class LogStage:
    """``#log(...)`` — pass-through host tap (LogStreamProcessor.java:219-277).

    ``n_filters`` / ``n_transforms`` record how much of the pre-window
    pipeline precedes the tap, so it prints exactly the rows (and columns)
    flowing at its position in the handler chain."""

    LEVELS = {
        "TRACE": logging.DEBUG, "DEBUG": logging.DEBUG, "INFO": logging.INFO,
        "WARN": logging.WARNING, "ERROR": logging.ERROR, "FATAL": logging.CRITICAL,
        "OFF": None,
    }

    def __init__(self, priority: str, message: str, show_event: bool,
                 prefix: str, n_filters: int, n_transforms: int):
        if priority.upper() not in self.LEVELS:
            raise CompileError(
                f"log priority must be one of {sorted(self.LEVELS)}, got '{priority}'")
        self.level = self.LEVELS[priority.upper()]
        self.message = message
        self.show_event = show_event
        self.prefix = prefix
        self.n_filters = n_filters
        self.n_transforms = n_transforms

    def emit(self, rows: List[tuple], timestamps: List[int]):
        if self.level is None:
            return
        for ts, row in zip(timestamps, rows):
            parts = [self.prefix]
            if self.message:
                parts.append(self.message + (", " if self.show_event else ""))
            if self.show_event:
                parts.append(f"StreamEvent{{ timestamp={ts}, data={list(row)} }}")
            logger.log(self.level, "%s", "".join(parts))


def _const(expr, what: str):
    if not isinstance(expr, Constant):
        raise CompileError(f"#log() {what} must be a constant")
    return expr.value


def plan_log(handler, query_name: str, n_filters: int, n_transforms: int) -> LogStage:
    """Parameter overloads per LogStreamProcessor.java:72-77:
    (), (message), (is.event.logged), (message, bool), (priority, message),
    (priority, message, bool)."""
    prefix = f"{query_name}: "
    ps = handler.parameters
    priority, message, show = "INFO", "", True
    if len(ps) == 1:
        v = _const(ps[0], "parameter")
        if isinstance(v, bool):
            show = v
        else:
            message = str(v)
    elif len(ps) == 2:
        a, b = _const(ps[0], "parameter"), _const(ps[1], "parameter")
        if isinstance(b, bool):
            message, show = str(a), b
        else:
            priority, message = str(a), str(b)
    elif len(ps) == 3:
        priority = str(_const(ps[0], "priority"))
        message = str(_const(ps[1], "message"))
        v = _const(ps[2], "is.event.logged")
        if not isinstance(v, bool):
            raise CompileError("#log() is.event.logged must be a bool constant")
        show = v
    elif len(ps) > 3:
        raise CompileError("#log() takes at most (priority, message, is.event.logged)")
    return LogStage(priority, message, show, prefix, n_filters, n_transforms)


def _numeric_arg(handler, i: int, name: str, resolver):
    fn, t = compile_expr(handler.parameters[i], resolver)
    if not is_numeric(t):
        raise CompileError(f"pol2Cart {name} must be numeric, got {t}")
    return fn


def plan_pol2cart(handler, resolver) -> TransformStage:
    """``#pol2Cart(theta, rho[, z])`` appends double x, y[, z] columns —
    theta in degrees (Pol2CartStreamFunctionProcessor.java examples:
    theta=0.7854, rho=5 -> x=4.9995..., y=0.0685...)."""
    n = len(handler.parameters)
    if n not in (2, 3):
        raise CompileError("pol2Cart needs (theta, rho) or (theta, rho, z)")
    theta_f = _numeric_arg(handler, 0, "theta", resolver)
    rho_f = _numeric_arg(handler, 1, "rho", resolver)
    z_f = _numeric_arg(handler, 2, "z", resolver) if n == 3 else None
    out = [Attribute("x", AttrType.DOUBLE), Attribute("y", AttrType.DOUBLE)]
    if z_f is not None:
        out.append(Attribute("z", AttrType.DOUBLE))

    def fn(cols, ctx):
        xp = ctx["xp"]
        th, thm = theta_f(cols, ctx)
        rh, rhm = rho_f(cols, ctx)
        m = None
        for part in (thm, rhm):
            if part is not None:
                m = part if m is None else (m | part)
        rad = xp.deg2rad(xp.astype(th, AttrType.DOUBLE))
        rho = xp.astype(rh, AttrType.DOUBLE)
        res = [("x", rho * xp.cos(rad), m), ("y", rho * xp.sin(rad), m)]
        if z_f is not None:
            zv, zm = z_f(cols, ctx)
            res.append(("z", xp.astype(zv, AttrType.DOUBLE), zm))
        return res

    return TransformStage(out, fn)


class StringParseCastStage(TransformStage):
    """Host-side ``convert(strAttr, '<numeric>')``: dictionary ids map to
    parsed values through a grow-on-demand LUT (the dictionary is
    append-only, so parsed entries stay valid). Runs as a host transform
    feeding the device step a synthetic numeric column; unparseable
    strings yield null (ConvertFunctionExecutor returns null on failure)."""

    def __init__(self, out_name: str, src_key: str, target: AttrType,
                 dictionary):
        self.out_attrs = [Attribute(out_name, target)]
        self._src = src_key
        self._target = target
        self._dict = dictionary
        self._vals = np.zeros(0, dtype_of(target))
        self._bad = np.zeros(0, bool)

    def _grow(self):
        n = len(self._dict)
        if n <= self._vals.shape[0]:
            return
        vals = np.zeros(n, self._vals.dtype)
        bad = np.zeros(n, bool)
        vals[: self._vals.shape[0]] = self._vals
        bad[: self._bad.shape[0]] = self._bad
        int_bounds = {
            AttrType.INT: (-2**31, 2**31 - 1),
            AttrType.LONG: (-2**63, 2**63 - 1),
        }
        for i in range(self._vals.shape[0], n):
            s = self._dict.decode(i)
            if self._target == AttrType.BOOL:
                # Boolean.parseBoolean: only (case-insensitive) 'true' is
                # True; anything else — padded strings included — is
                # False, never null
                vals[i] = (s or "").lower() == "true"
                continue
            try:
                f = float(s)
                if self._target in int_bounds:
                    v = int(f)
                    lo, hi = int_bounds[self._target]
                    if not (lo <= v <= hi):
                        raise OverflowError(v)
                    vals[i] = v
                else:
                    vals[i] = f
            except (TypeError, ValueError, OverflowError):
                bad[i] = True   # unparseable/out-of-range -> null
        self._vals, self._bad = vals, bad

    def apply(self, cols, ctx):
        # numpy-only (host transform); ids clip to the LUT for safety
        self._grow()
        cols = dict(cols)
        ids = np.asarray(cols[self._src])
        safe = np.clip(ids, 0, max(len(self._vals) - 1, 0))
        name = self.out_attrs[0].name
        B = ids.shape[0]
        if len(self._vals) == 0:
            cols[name] = np.zeros(B, dtype_of(self._target))
            cols[name + "?"] = np.ones(B, bool)
            return cols
        cols[name] = self._vals[safe]
        null = np.asarray(cols.get(self._src + "?", np.zeros(B, bool)))
        cols[name + "?"] = null | self._bad[safe] | (ids < 0)
        return cols


def _format_float(v) -> str:
    # unique=True: shortest round-trip text at the value's own precision;
    # trim="0" keeps Java's "N.0" form for integral values
    return np.format_float_positional(v, unique=True, trim="0")


class NumericFormatCastStage(TransformStage):
    """Host-side ``convert(numericAttr, 'string')``: formats each batch's
    unique values once and dictionary-encodes them (string columns are
    dictionary ids). Distinct-value cardinality grows the app dictionary —
    bounded-domain attributes are the intended use."""

    def __init__(self, out_name: str, src_key: str, src_type: AttrType,
                 dictionary):
        self.out_attrs = [Attribute(out_name, AttrType.STRING)]
        self._src = src_key
        self._src_type = src_type
        self._dict = dictionary

    def apply(self, cols, ctx):
        cols = dict(cols)
        vals = np.asarray(cols[self._src])
        uniq, inv = np.unique(vals, return_inverse=True)
        if self._src_type in (AttrType.INT, AttrType.LONG):
            strs = np.array([str(int(v)) for v in uniq], object)
        elif self._src_type == AttrType.BOOL:
            strs = np.array(["true" if v else "false" for v in uniq], object)
        else:
            # shortest round-trip representation at the SOURCE precision
            # (Java String.valueOf(float) prints "1.1", not the float64
            # expansion of the float32 bits)
            strs = np.array([_format_float(v) for v in uniq], object)
        ids = self._dict.encode_array(strs)[inv].astype(np.int32)
        name = self.out_attrs[0].name
        cols[name] = ids
        cols[name + "?"] = np.asarray(
            cols.get(self._src + "?", np.zeros(vals.shape[0], bool)))
        return cols


class InProbeStage(TransformStage):
    """``<cond> in Table`` (reference InConditionExpressionExecutor): an
    exists-probe computing, per batch row, whether ANY table row satisfies
    the compiled pair condition, as a synthetic bool column the filter
    reads. The ``[B, C]`` broadcast is the table's own ``_match`` (the
    machinery and binding rules of join, update and delete probes)."""

    # reads the table's current rows at every batch: the query runs its
    # transform chain on the host (the planner checks this flag)
    host_only = True

    def __init__(self, out_name: str, table, cond_fn):
        self.out_attrs = [Attribute(out_name, AttrType.BOOL)]
        self._table = table
        self._cond = cond_fn

    def apply(self, cols, ctx):
        from siddhi_tpu_torch.core.table.in_memory_table import host

        cols = dict(cols)
        present = host(self._table._match(self._cond, cols, ctx).any(dim=1))
        name = self.out_attrs[0].name
        cols[name] = present
        cols[name + "?"] = np.zeros(present.shape[0], bool)
        return cols


class StreamFunction:
    """Extension base for custom ``#name(args)`` stream functions: declare
    ``out_attrs`` (or make it a callable of the argument types) and
    implement ``apply(xp, *arrays) -> one array per out attr``, vectorized
    over the batch (``xp`` is ``ops/expressions.TorchXP`` on the device,
    ``NUMPY_XP`` on the host) — the SPI analog of StreamFunctionProcessor.process()
    (reference per-event) as a single columnar call."""

    out_attrs: object = None  # List[(name, AttrType)] or callable(arg_types)

    @staticmethod
    def apply(xp, *args):  # pragma: no cover - interface
        raise NotImplementedError


def plan_extension_stream_function(ext, handler, resolver) -> TransformStage:
    compiled = [compile_expr(a, resolver) for a in handler.parameters]
    out_spec = ext.out_attrs
    if callable(out_spec):
        out_spec = out_spec([t for _, t in compiled])
    if not out_spec:
        raise CompileError(
            f"stream function '{handler.name}' declares no out_attrs")
    out_attrs = [Attribute(n, t) for n, t in out_spec]

    def fn(cols, ctx):
        xp = ctx["xp"]
        vals, m = [], None
        for f, _t in compiled:
            v, vm = f(cols, ctx)
            vals.append(v)
            if vm is not None:
                m = vm if m is None else (m | vm)
        outs = ext.apply(xp, *vals)
        if len(out_attrs) == 1 and not isinstance(outs, (tuple, list)):
            outs = (outs,)
        return [(a.name, xp.astype(v, a.type), m)
                for a, v in zip(out_attrs, outs)]

    return TransformStage(out_attrs, fn)


def plan_stream_function(handler, resolver, query_name: str,
                         n_filters: int, n_transforms: int):
    """Factory: returns a TransformStage or a LogStage for a
    ``StreamFunction`` handler (SingleInputStreamParser.generateProcessor
    dispatch role)."""
    ns = getattr(handler, "namespace", "") or ""
    full_name = f"{ns}:{handler.name}" if ns else handler.name
    if not ns:
        # built-ins live in the root namespace only — '#custom:log' must
        # resolve through the extension registry, not shadow #log
        name = handler.name.lower()
        if name == "log":
            return plan_log(handler, query_name, n_filters, n_transforms)
        if name == "pol2cart":
            return plan_pol2cart(handler, resolver)
    ext = resolve_extension("streamFunction", full_name)
    if ext is not None:
        return plan_extension_stream_function(ext, handler, resolver)
    raise CompileError(f"unknown stream function '{full_name}'")
