"""On-demand (store) queries against tables and named windows.

Counterpart of ``siddhi_tpu/core/query/on_demand.py``, the mirror of
reference ``util/parser/OnDemandQueryParser.java`` (find/insert/delete/
update runtime assembly): the store's current contents become one
columnar batch, the `on` condition a batched mask, and the selector
(aggregations, group by, having, order by/limit) the same stage streaming
queries run. A find over an equality on an indexed table attribute
probes the table's host value -> slots map instead of scanning. A find
over an incremental aggregation (``within ... per ...``) reads the
stitched buckets of one duration (``IncrementalAggregationRuntime.contents``)
as that batch.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.event import Event, HostBatch
from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver
from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY, plan_selector
from siddhi_tpu_torch.core.table.in_memory_table import (
    TBL_PREFIX, TableConditionResolver, host, to_device)
from siddhi_tpu_torch.ops.expressions import (
    NUMPY_XP,
    TS_KEY,
    TYPE_KEY,
    VALID_KEY,
    CompileError,
    TorchXP,
    compile_condition,
)
from siddhi_tpu_torch.query_api.definitions import AttrType
from siddhi_tpu_torch.query_api.execution import OnDemandQuery
from siddhi_tpu_torch.query_api.expressions import Variable


def _aggregation_contents(agg, oq: OnDemandQuery, dictionary):
    """Synthesize the stitched per-duration rows of an incremental
    aggregation as a columnar batch (reference OnDemandQuery `within ...
    per ...` against an aggregation)."""
    from siddhi_tpu_torch.core.aggregation.incremental import parse_duration_name
    from siddhi_tpu_torch.query_api.expressions import Constant, TimeConstant

    store = oq.input_store
    if store.per is None:
        raise CompileError(
            f"aggregation '{agg.definition.id}' queries need `per '<duration>'`")
    if not isinstance(store.per, Constant) or not isinstance(store.per.value, str):
        raise CompileError("`per` must be a duration string constant")
    duration = parse_duration_name(store.per.value)

    within = None
    w = store.within
    if w is not None:
        from siddhi_tpu_torch.core.aggregation.within_time import (
            WithinFormatError, resolve_within_pair, single_within_range)

        def _const(x):
            if isinstance(x, (Constant, TimeConstant)):
                return x.value
            raise CompileError(
                "within bounds must be constants (unix ms or "
                "'yyyy-MM-dd HH:mm:ss' date strings)")

        try:
            if isinstance(w, tuple):
                within = resolve_within_pair(_const(w[0]), _const(w[1]))
            elif isinstance(w, Constant) and isinstance(w.value, str):
                # single wildcard pattern: the whole calendar unit it names
                # (IncrementalStartTimeEndTimeFunctionExecutor.java:139-200)
                within = single_within_range(w.value)
            else:
                # single-bound within must be a date-pattern STRING
                # (startTimeEndTime single-arg validation)
                raise CompileError(
                    "a single within bound must be a date-pattern string "
                    "('yyyy-MM-dd HH:mm:ss', '**' wildcards allowed)")
        except WithinFormatError as e:
            raise CompileError(str(e)) from None

    return agg.contents(duration, within)


def _run_mutation(oq: OnDemandQuery, app_runtime, dictionary) -> List[Event]:
    """On-demand table mutations (reference ``OnDemandQueryParser`` +
    StoreQuery INSERT/DELETE/UPDATE/UPDATE-OR-INSERT runtimes)."""
    from siddhi_tpu_torch.core.query.output_callbacks import _compile_assignments
    from siddhi_tpu_torch.ops.expressions import compile_expr
    from siddhi_tpu_torch.ops.types import dtype_of

    out = oq.output_stream
    target = getattr(out, "target_id", None)
    table = app_runtime.tables.get(target or "")
    if table is None:
        raise CompileError(
            f"on-demand {oq.type} target '{target}' is not a defined table")
    tdef = table.definition
    const_resolver = TableConditionResolver(tdef, None, dictionary)

    # materialize the SELECT projection as a one-row pseudo event: its
    # aliases are the mutation's "triggering event" attributes, so
    # `select 100L as vol delete ... on StockTable.volume == vol` and
    # `select "X" as s update ... set StockTable.symbol = s` resolve like
    # their streaming counterparts (reference OnDemandQueryParser builds a
    # matching StateEvent the same way)
    from siddhi_tpu_torch.query_api.definitions import (
        Attribute, StreamDefinition as _SD)

    ev_def = None
    ev_batch = None
    sel = (oq.selector.selection_list
           if oq.selector is not None else []) or []
    if sel:
        ctx = {"xp": NUMPY_XP, "current_time": 0}
        row = {TS_KEY: np.zeros(1, np.int64),
               TYPE_KEY: np.zeros(1, np.int8),
               VALID_KEY: np.ones(1, bool)}
        ev_attrs = []
        sel_names = []
        for i, oa in enumerate(sel):
            fn, t = compile_expr(oa.expression, const_resolver)
            try:
                v, mk = fn({VALID_KEY: row[VALID_KEY]}, ctx)
            except KeyError as e:
                raise CompileError(
                    "on-demand mutation projections must be constant "
                    f"expressions (no column references): {e}") from None
            try:
                name = oa.name
            except ValueError:
                name = f"_c{i}"   # unaliased constant (positional insert)
            row[name] = np.broadcast_to(np.asarray(v, dtype_of(t)), (1,))
            row[name + "?"] = np.broadcast_to(
                np.asarray(mk, bool) if mk is not None
                else np.zeros(1, bool), (1,))
            ev_attrs.append(Attribute(name=name, type=t))
            sel_names.append(name)
        ev_def = _SD(id="__on_demand__", attributes=ev_attrs)
        ev_batch = HostBatch(row)
    resolver = TableConditionResolver(tdef, ev_def, dictionary)

    if oq.type == "insert":
        # `select <values> insert into Table` — positional mapping
        if len(sel) != len(tdef.attributes):
            raise CompileError(
                f"insert into '{target}' needs {len(tdef.attributes)} values")
        row = {TS_KEY: np.zeros(1, np.int64),
               TYPE_KEY: np.zeros(1, np.int8),
               VALID_KEY: np.ones(1, bool)}
        for attr, sname in zip(tdef.attributes, sel_names):
            row[attr.name] = np.asarray(
                ev_batch.cols[sname], dtype_of(attr.type))
            row[attr.name + "?"] = np.asarray(ev_batch.cols[sname + "?"])
        table.insert(HostBatch(row))
        return []

    if oq.type == "delete":
        cond = compile_condition(out.on_delete, resolver) \
            if out.on_delete is not None else None
        table.delete(cond, ev_batch)
        return []

    cond = compile_condition(out.on_update, resolver) \
        if out.on_update is not None else None
    if out.update_set is None:
        raise CompileError(f"on-demand {oq.type} needs a `set` clause")
    assignments = _compile_assignments(table, ev_def, out.update_set, resolver)
    if oq.type == "update":
        table.update(cond, assignments, ev_batch)
        return []
    if oq.type == "update_or_insert":
        m = table.update(cond, assignments, ev_batch)
        if not bool(torch.as_tensor(m).any()):
            # no row matched: insert one built from the set clause
            ctx = {"xp": NUMPY_XP, "current_time": 0}
            ones = np.ones(1, bool)
            ev = {VALID_KEY: ones}
            if ev_batch is not None:
                from siddhi_tpu_torch.core.table.in_memory_table import EV_PREFIX

                for k, v in ev_batch.cols.items():
                    ev[EV_PREFIX + k] = np.asarray(v)[:, None]
            row = {TS_KEY: np.zeros(1, np.int64),
                   TYPE_KEY: np.zeros(1, np.int8),
                   VALID_KEY: ones}
            # the reference inserts the PROJECTED pseudo event itself
            # (UpdateOrInsertReducer converts the matching StateEvent), so
            # name-matched projection columns seed the row; the set clause
            # then overrides (they usually agree — test15: volume 123
            # comes from the projection, not the set)
            set_cols = {}
            set_masks = {}
            for col_name, fn, _t in assignments:
                try:
                    v, mk = fn(ev, ctx)
                except KeyError as e:
                    raise CompileError(
                        "on-demand update-or-insert: the `set` clause "
                        "references a table column, which has no value on "
                        f"the insert (no-match) branch: {e}") from None
                set_cols[col_name] = np.asarray(v).reshape(-1)[:1]
                set_masks[col_name] = (np.asarray(mk, bool).reshape(-1)[:1]
                                       if mk is not None else np.zeros(1, bool))
            for attr in tdef.attributes:
                if attr.name in set_cols:
                    row[attr.name] = np.broadcast_to(
                        np.asarray(set_cols[attr.name], dtype_of(attr.type)), (1,))
                    row[attr.name + "?"] = set_masks[attr.name]
                elif ev_batch is not None and attr.name in ev_batch.cols:
                    row[attr.name] = np.asarray(
                        ev_batch.cols[attr.name], dtype_of(attr.type))[:1]
                    row[attr.name + "?"] = np.asarray(
                        ev_batch.cols[attr.name + "?"])[:1]
                else:
                    row[attr.name] = np.zeros(1, dtype_of(attr.type))
                    row[attr.name + "?"] = np.ones(1, bool)   # null
            table.insert(HostBatch(row))
        return []
    raise CompileError(f"unsupported on-demand query type '{oq.type}'")


def extract_eq_probe(cond, table_def, probe_attrs):
    """Split an `on` condition into (attr, const, residual) when it has a
    top-level equality conjunct ``T.attr == <constant>`` over an indexed
    attribute — the shape the reference compiles to an
    ``IndexedEventHolder`` probe (CompareCollectionExecutor over
    indexData). Returns None when no probe applies."""
    from siddhi_tpu_torch.query_api.expressions import And, Compare, Constant

    def attr_const(e):
        if not isinstance(e, Compare) or e.operator != "==":
            return None
        for var, const in ((e.left, e.right), (e.right, e.left)):
            if (isinstance(var, Variable) and isinstance(const, Constant)
                    and var.stream_id in (None, table_def.id)
                    and var.attribute_name in probe_attrs):
                return var.attribute_name, const
        return None

    hit = attr_const(cond)
    if hit is not None:
        return hit[0], hit[1], None
    if isinstance(cond, And):
        for this, other in ((cond.left, cond.right), (cond.right, cond.left)):
            hit = attr_const(this)
            if hit is not None:
                return hit[0], hit[1], other
    return None


def run_on_demand_query(source: str, app_runtime) -> List[Event]:
    """Parse/compile-once, execute-per-call: compiled FIND runtimes are
    cached per query text, capped at 50 with oldest-inserted eviction
    (reference ``SiddhiAppRuntimeImpl.java:344-351``). Mutations recompile
    per call (their compile is a fraction of the store write they do).

    Barrier scope: mutations and table/named-window finds hold the app
    barrier (their stores are mutated by streaming output under the same
    barrier). Aggregation store-queries run WITHOUT it — the single-store
    runtime snapshots under its own lock, and the serving tier's sharded
    runtime reads epoch-pinned per-shard snapshots — so a storm of
    dashboard `within ... per ...` reads never blocks ingest."""
    cache = getattr(app_runtime, "_on_demand_cache", None)
    if cache is None:
        from collections import OrderedDict

        cache = app_runtime._on_demand_cache = OrderedDict()
    rt = cache.get(source)
    if rt is None:
        oq: OnDemandQuery = SiddhiCompiler.parse_on_demand_query(source)
        dictionary = app_runtime.app_context.string_dictionary
        if oq.type != "find" or oq.input_store is None:
            with app_runtime._barrier:
                return _run_mutation(oq, app_runtime, dictionary)
        rt = OnDemandFindRuntime(oq, app_runtime, dictionary)
        cache[source] = rt
        if len(cache) > 50:
            cache.popitem(last=False)
    if rt.agg is not None:
        return rt.execute()
    with app_runtime._barrier:
        return rt.execute()


class OnDemandFindRuntime:
    """Compiled FIND runtime (reference *OnDemandQueryRuntime classes):
    everything derivable from the query TEXT and the store's definition —
    resolvers, probe extraction, compiled conditions, the selector plan,
    group-key executors — happens once here; ``execute`` only touches
    store contents."""

    def __init__(self, oq: OnDemandQuery, app_runtime, dictionary):
        import threading

        self.oq = oq
        self.app_runtime = app_runtime
        self.dictionary = dictionary
        # callers are already serialized by the app barrier
        # (SiddhiAppRuntime.query), but the cached runtime must not rely
        # on that: its keyer/plan state is per-execute anyway and this
        # lock keeps direct executes safe too
        self._lock = threading.Lock()
        store_id = oq.input_store.store_id
        self.table = app_runtime.tables.get(store_id)
        self.window = app_runtime.named_windows.get(store_id)
        self.agg = app_runtime.aggregations.get(store_id)
        if self.table is not None:
            self.definition = self.table.definition
        elif self.window is not None:
            self.definition = self.window.definition
        elif self.agg is not None:
            self.definition = self.agg.output_definition()
        else:
            raise CompileError(
                f"'{store_id}' is not a defined table/window/aggregation")
        definition = self.definition

        self.cond = None
        self.probe = None
        self.residual_cond = None
        if oq.input_store.on_condition is not None:
            resolver = TableConditionResolver(definition, None, dictionary)
            probe = None
            if self.table is not None and hasattr(self.table, "probe_attrs"):
                probe = extract_eq_probe(oq.input_store.on_condition,
                                         definition, self.table.probe_attrs())
                if probe is not None:
                    # a narrowing cast into the column dtype would change
                    # equality semantics (2.5 -> 2): scan instead
                    from siddhi_tpu_torch.core.plan.query_planner import _probe_type_safe

                    attr_t = definition.attribute(probe[0]).type
                    if not _probe_type_safe(attr_t, probe[1].type):
                        probe = None
            self.probe = probe
            if probe is not None:
                if probe[2] is not None:
                    self.residual_cond = compile_condition(probe[2], resolver)
            else:
                self.cond = compile_condition(
                    oq.input_store.on_condition, resolver)

        sel_resolver = SingleStreamResolver(
            definition, dictionary, ref_id=oq.input_store.store_reference_id,
            synthetic={})
        self.plan = plan_selector(
            selector=oq.selector,
            input_attrs=[(a.name, a.type) for a in definition.attributes],
            resolver=sel_resolver,
            output_event_type="current",
            # the store's contents are ONE batch chunk: grouped/aggregated
            # finds return one row per group (the running aggregate's last
            # row), matching reference OnDemandQueryTableTestCase test3
            # (2 groups -> 2 rows, sum aggregated across each group)
            batch_mode=True,
            dictionary=dictionary,
        )
        self.group_fns = None
        if self.plan.group_by:
            from siddhi_tpu_torch.ops.expressions import compile_expr

            # compiled key executors are cached; the keyer itself is
            # rebuilt per execute — a persistent keyer's dense ids never
            # recycle, so state would grow with every key EVER seen
            self.group_fns = [compile_expr(v, sel_resolver)
                              for v in oq.selector.group_by_list]

    def execute(self) -> List[Event]:
        with self._lock:
            return self._execute()

    def _execute(self) -> List[Event]:
        table, dictionary = self.table, self.dictionary
        dev = self.app_runtime.app_context.device
        probe = self.probe
        slots = None
        if self.agg is not None:
            _definition, cols, valid = _aggregation_contents(
                self.agg, self.oq, dictionary)
        else:
            store = table if table is not None else self.window
            with getattr(store, "_lock"):
                if probe is not None:
                    # probe and snapshot under one lock: the slots must
                    # index the state the output columns come from
                    attr, const, _residual = probe
                    value = const.value
                    if const.type == AttrType.STRING:
                        value = dictionary.encode(value)
                    slots = table.index_candidates(attr, value)
                cols, valid = store.contents()
        cols = {k: to_device(v, dev) for k, v in cols.items()}
        valid = to_device(valid, dev).to(torch.bool)
        C = valid.shape[0]
        match = valid
        if probe is not None:
            # an indexed equality: the candidate slots of the hash probe,
            # the residual condition over those only (sub-linear in the
            # table size: the IndexEventHolder probe path)
            keep = slots[host(valid)[slots]] if slots.size else slots
            if self.residual_cond is not None and keep.size:
                sub = {TBL_PREFIX + k: host(v)[keep][None, :] for k, v in cols.items()}
                sub[TS_KEY] = host(cols[TS_KEY])[keep][None, :]
                rm = np.broadcast_to(
                    np.asarray(self.residual_cond(sub, {"xp": NUMPY_XP})),
                    (1, keep.size))[0]
                keep = keep[rm]
            sel = np.zeros(C, bool)
            sel[keep] = True
            match = match & torch.from_numpy(sel).to(dev)
        elif self.cond is not None:
            ev = {TBL_PREFIX + k: v[None, :] for k, v in cols.items()}
            ev[TS_KEY] = cols[TS_KEY][None, :]
            m = torch.as_tensor(self.cond(ev, {"xp": TorchXP(dev)}), device=dev)
            match = match & m.expand(1, C)[0]

        sel_cols = dict(cols)
        sel_cols[VALID_KEY] = match
        sel_cols[TYPE_KEY] = torch.zeros(C, dtype=torch.int8, device=dev)
        sel_cols[GK_KEY] = torch.zeros(C, dtype=torch.int32, device=dev)
        plan = self.plan
        if self.group_fns is not None:
            from siddhi_tpu_torch.core.query.runtime import GroupKeyer

            # a fresh keyer per call: group ids sized to the current rows
            keyer = GroupKeyer(self.group_fns)
            sel_cols[GK_KEY] = torch.from_numpy(
                keyer({k: host(v) for k, v in sel_cols.items()})).to(dev)
            plan.num_keys = max(16, len(keyer))
        if plan.needs_str_rank:
            # string order-by keys sort lexicographically, not by id
            from siddhi_tpu_torch.core.plan.selector_plan import STR_RANK

            sel_cols[STR_RANK] = to_device(dictionary.rank_table(), dev)
        _state, out = plan.apply(plan.init_state(dev), sel_cols,
                                 {"xp": TorchXP(dev), "current_time": 0})
        out = {k: host(v) for k, v in out.items()}
        return HostBatch(out).to_events(plan.output_attrs, dictionary)
