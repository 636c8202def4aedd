"""Machine-readable eligibility reason codes.

Counterpart of the first half of ``siddhi_tpu/core/eligibility.py``. The
engine runs one query under several strategies (fused fan-out, pipelined,
device-routed, device joins); each strategy's planner hook says WHY a
runtime cannot take its path. Every such reason is a :class:`Reason`: a
``str`` subclass (substring asserts and f-string interpolations keep
working) carrying a stable :class:`ReasonCode`. ``code_of`` normalizes any
surface value (None = eligible, Reason, bare str) to a code; a bare str
maps to ``UNKNOWN``.

The per-app census (its surfaces, ``census_of``, ``register_census`` and
its ``eligibility.<surface>.<code>.<query>`` counters) is ROADMAP A.10.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional


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
