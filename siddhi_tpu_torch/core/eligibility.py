"""Machine-readable eligibility reason codes and the per-app census.

Counterpart of ``siddhi_tpu/core/eligibility.py``. The engine runs one
query under several strategies (fused fan-out, pipelined, device-routed,
device joins); each strategy's planner hook says WHY a runtime cannot take
its path (``rt.engine_reason``, ``rt.pipeline_reason``,
``parallel.mesh.route_ineligibility``,
``fanout_plan.fusion_ineligibility``). Every such reason is a
:class:`Reason`: a ``str`` subclass (substring asserts and f-string
interpolations keep working) carrying a stable :class:`ReasonCode`.
``code_of`` normalizes any surface value (None = eligible, Reason, bare
str) to a code; a bare str maps to ``UNKNOWN``, which the semantic fuzzer
(``siddhi_tpu_torch/fuzz/``) treats as an unexplained fallback.

``register_census`` walks a freshly built app's query runtimes, records
each query's classification on every surface into
``app_runtime.eligibility_census`` and counts it on the app's telemetry
registry as ``eligibility.<surface>.<code>.<query>`` (exported as the
``siddhi_eligibility_total{surface,code,query}`` family by
``observability/export.py``).

One code is the port's own: ``NOT_PORTED``, a shape the reference runs on
a strategy the port has not ported yet (the planner's text names the
ROADMAP item). The fuzzer reports such rows as declared gaps. No surface
gives it today: the routed surface reports the reference's codes for
every shape (distinct value tables and partitioned keyed-length joins
route), so the fuzzer's declared gaps are empty.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional, Tuple

# census surfaces (the strategy axes a query is classified on)
SURFACE_ROUTE = "route"                  # device-routed mesh sharding
SURFACE_FUSION = "fusion"                # fan-out fusion membership
SURFACE_JOIN_ENGINE = "join_engine"      # device join engine
SURFACE_JOIN_PIPELINE = "join_pipeline"  # join CompletionPump ride
SURFACES = (SURFACE_ROUTE, SURFACE_FUSION, SURFACE_JOIN_ENGINE,
            SURFACE_JOIN_PIPELINE)


class ReasonCode(str, Enum):
    """Stable machine-readable eligibility codes. Values are the wire
    spelling (census counters, fuzz reports, /metrics labels): never
    renumbered, only appended."""

    # pseudo-codes
    ELIGIBLE = "ELIGIBLE"            # reason is None: the strategy applies
    UNKNOWN = "UNKNOWN"              # bare-str reason (a coverage gap)

    # shared across surfaces
    HOST_WINDOW = "HOST_WINDOW"              # host-mode window stage
    ORDER_LIMIT = "ORDER_LIMIT"              # order by / limit / offset
    GROUPED_SELECT = "GROUPED_SELECT"        # host keyed select between stages
    INDEXED_PROBE = "INDEXED_PROBE"          # indexed table probe
    STORE_SIDE = "STORE_SIDE"                # shared-store probe side
    SCHEDULER_WINDOW = "SCHEDULER_WINDOW"    # timer-driven window
    DISABLED = "DISABLED"                    # config opt-out (legacy mode)

    # device routing (parallel/mesh.route_ineligibility)
    NFA_QUERY = "NFA_QUERY"                  # pattern/sequence state machine
    WINDOW_NOT_GLOBAL_AWARE = "WINDOW_NOT_GLOBAL_AWARE"
    GLOBAL_WINDOW = "GLOBAL_WINDOW"          # non-partitioned window
    UNKEYED = "UNKEYED"                      # nothing to route by
    INNER_PARTITION_STREAM = "INNER_PARTITION_STREAM"  # '#stream' input
    JOIN_UNPARTITIONED = "JOIN_UNPARTITIONED"
    GLOBAL_SIDE = "GLOBAL_SIDE"              # global join side in a partition

    # device join engine (core/join/engine.py)
    PARTITIONED = "PARTITIONED"              # keyed rings partition-local
    WINDOW_KIND = "WINDOW_KIND"              # side window has no adapter
    NOT_ATTACHED = "NOT_ATTACHED"            # pre-classification default
    NO_WINDOW = "NO_WINDOW"                  # side without a window stage

    # fan-out fusion (core/plan/fanout_plan.py + JoinSideProxy)
    NOT_PLAIN_RUNTIME = "NOT_PLAIN_RUNTIME"  # join/pattern runtime classes
    HOST_TRANSFORM = "HOST_TRANSFORM"        # host-side transform chain
    LOG_TAPS = "LOG_TAPS"                    # #log() host taps
    SHARDED = "SHARDED"                      # already routed over a mesh
    NO_DEVICE_ENGINE = "NO_DEVICE_ENGINE"    # join side w/o device engine
    SELF_JOIN = "SELF_JOIN"                  # both sides on one junction

    # the port's own: the reference takes the strategy, the port has not
    # ported it yet (the reason's text names the ROADMAP item)
    NOT_PORTED = "NOT_PORTED"


class Reason(str):
    """A free-text ineligibility reason carrying its stable code.

    A ``str`` subclass on purpose: every consumer that reads the text
    sees exactly the text; tooling reads ``.code``."""

    __slots__ = ("code",)

    def __new__(cls, code: ReasonCode, detail: str) -> "Reason":
        r = super().__new__(cls, detail)
        r.code = code
        return r

    def __reduce__(self):  # keep .code across pickling
        return (Reason, (self.code, str(self)))


def reason(code: ReasonCode, detail: str) -> Reason:
    """The one constructor every eligibility surface uses."""
    return Reason(code, detail)


def code_of(value: Optional[str]) -> ReasonCode:
    """Normalize a surface value to its code: ``None`` is ELIGIBLE, a
    :class:`Reason` carries its own code, and a bare string is UNKNOWN."""
    if value is None:
        return ReasonCode.ELIGIBLE
    if isinstance(value, Reason):
        return value.code
    return ReasonCode.UNKNOWN


# --------------------------------------------------------------- census

def census_of(app_runtime) -> Dict[str, List[Tuple[str, ReasonCode, str]]]:
    """Classify every query runtime on every surface it takes part in.

    Returns ``{query_name: [(surface, code, detail), ...]}``. A pure read:
    it consults the functions the planners do and mutates nothing."""
    from siddhi_tpu_torch.core.plan.fanout_plan import fusion_ineligibility
    from siddhi_tpu_torch.parallel.mesh import route_ineligibility

    out: Dict[str, List[Tuple[str, ReasonCode, str]]] = {}
    for name, q in app_runtime.query_runtimes.items():
        rows: List[Tuple[str, ReasonCode, str]] = []
        r = route_ineligibility(q)
        rows.append((SURFACE_ROUTE, code_of(r), str(r or "")))
        if getattr(q, "sides", None) is not None:
            # a join: fusion is decided per side proxy (the junction
            # receivers), not on the JoinQueryRuntime itself
            proxies = getattr(q, "_proxies", None)
            if proxies:
                for _key, proxy in sorted(proxies.items()):
                    fr = proxy.fusion_ineligibility()
                    rows.append((SURFACE_FUSION, code_of(fr), str(fr or "")))
            else:
                fr = fusion_ineligibility(q)
                rows.append((SURFACE_FUSION, code_of(fr), str(fr or "")))
            er = getattr(q, "engine_reason", None)
            pr = getattr(q, "pipeline_reason", None)
            rows.append((SURFACE_JOIN_ENGINE, code_of(er), str(er or "")))
            rows.append((SURFACE_JOIN_PIPELINE, code_of(pr), str(pr or "")))
        else:
            fr = fusion_ineligibility(q)
            rows.append((SURFACE_FUSION, code_of(fr), str(fr or "")))
        out[name] = rows
    return out


def register_census(app_runtime) -> None:
    """Record the build-time census: kept on
    ``app_runtime.eligibility_census`` for direct reads (the fuzzer) and
    counted for each (surface, code, query) on the app's telemetry registry
    for the /metrics family. Called once an app build, right after fan-out
    planning."""
    census = census_of(app_runtime)
    app_runtime.eligibility_census = census
    tel = getattr(app_runtime.app_context, "telemetry", None)
    if tel is None:
        return
    for qname, rows in census.items():
        for surface, code, _detail in rows:
            tel.count(f"eligibility.{surface}.{code.value}.{qname}")
