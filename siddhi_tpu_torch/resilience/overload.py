"""Overload control: per-app quotas, shed policies and a memory budget.

Counterpart of ``siddhi_tpu/resilience/overload.py``. One process hosts a
fleet of tenant apps; without this layer an ``@Async`` producer blocks on
a full queue for as long as its consumer stalls, and every capacity-growth
site grows without a ceiling, so one hot or hostile tenant can wedge its
producers or exhaust the card's memory for every app of the process.

- **Per-app ingest quotas.** ``OverloadConfig`` bounds the @Async
  junction queue depth (per stream or app-wide), the app's in-flight
  dispatch pipeline (``CompletionPump`` entries) and an approximate
  device-memory budget charged at every capacity-growth site. Past the
  queue quota a per-stream policy applies:

  * ``block``: the producer waits, bounded; every ``block_timeout_s``
    without progress it escalates to the app supervisor
    (``AppSupervisor.notify_backpressure`` replaces a dead or wedged
    consumer) and counts ``resilience.enqueue_timeouts``;
  * ``shed_oldest``: the oldest queued unit is evicted to make room
    (the freshest data wins: dashboards, tickers);
  * ``shed_newest``: the incoming unit is dropped (the history in order
    wins: audit feeds).

  A shed counts its events into ``resilience.shed_events`` and the
  stream's ``junction.<sid>.shed_events`` counter, and discards its
  ingest-WAL record (``IngestWAL.discard``), so a checkpoint restore
  replays exactly the suffix that was not shed.

- **Weighted fair scheduling.** ``FairScheduler`` keeps a decayed
  delivery rate per app; an app whose share of recent work exceeds its
  weighted fair share while a sibling app is backlogged has its @Async
  worker yield briefly before a delivery and at each pipeline submit, so
  one flooded tenant cannot take the host cores and the card's dispatch
  slots from its siblings.

- **The device-memory budget gate.** ``ensure_memory_budget`` runs at
  every capacity-growth site (``QueryRuntime._ensure_capacity``,
  ``parallel.mesh.ensure_routed_capacity``, the aggregation fold, the
  table's ``_ensure_room``) before the grown state is allocated and
  before the step's CUDA graph and program-cache entry are dropped: past
  the budget the growth is denied with a ``FatalQueryError`` naming
  ``siddhi_tpu.quota_memory_mb``, and the old state, graph and entry
  stay as they were. The projection reads tensor metadata only
  (``numel() * element_size()``), never a device value. The ledger is
  approximate by design: it holds the dense states the growth sites
  charge, not the graphs' pools, the program cache's slots or host
  bytes.

Free when off: an app without quota keys never registers, its
``app_context.overload`` stays ``None``, and every call site is one
``getattr``.

Config keys (``core/util/knobs.py``): ``siddhi_tpu.quota_queue_depth
[.<stream>]``, ``siddhi_tpu.shed_policy[.<stream>]``,
``siddhi_tpu.quota_pipeline_depth``, ``siddhi_tpu.quota_memory_mb``,
``siddhi_tpu.quota_block_timeout_s``, ``siddhi_tpu.fair_weight``,
``siddhi_tpu.quota_query_cap``; in code ``SiddhiAppRuntime.enable_overload``.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.core.util.knobs import SHED_POLICIES

log = logging.getLogger(__name__)

# bounded-wait slice of quota waits: short enough that a drained queue
# admits at once, long enough not to spin the core
_WAIT_SLICE_S = 0.002
# the producer's blocking-put slice (the junction's bounded put): each
# slice re-checks the worker's fatal error
BLOCK_PUT_SLICE_S = 0.25
# escalation period of a producer blocked on a full queue, with or
# without quotas
DEFAULT_BLOCK_TIMEOUT_S = 5.0


def _units(item) -> int:
    """Event count of one junction queue unit (an event chunk or a
    HostBatch)."""
    if item is None:
        return 0
    if isinstance(item, list):
        return len(item)
    size = getattr(item, "size", None)
    return int(size) if size is not None else 1


@dataclass
class OverloadConfig:
    """One app's quotas. ``None`` disables a bound."""

    # queued units an @Async junction admits before its shed policy
    # applies (the admission bound; @Async buffer.size is the allocation)
    queue_quota: Optional[int] = None
    queue_quota_per_stream: Dict[str, int] = field(default_factory=dict)
    # past the queue quota: block | shed_oldest | shed_newest
    shed_policy: str = "block"
    shed_policy_per_stream: Dict[str, str] = field(default_factory=dict)
    # app-wide cap on CompletionPump entries in flight: past it, each
    # submitting owner keeps ONE riding entry, which bounds the total at
    # max(quota, one per active query)
    pipeline_quota: Optional[int] = None
    # approximate device-memory budget (bytes) charged at capacity growth
    memory_budget_bytes: Optional[int] = None
    # a blocked producer's wait before it escalates to the supervisor
    block_timeout_s: float = DEFAULT_BLOCK_TIMEOUT_S
    # weighted fair share across registered apps (FairScheduler)
    fair_weight: float = 1.0
    # per-app REST /query admission cap
    query_cap: Optional[int] = None

    def __post_init__(self):
        for p in [self.shed_policy, *self.shed_policy_per_stream.values()]:
            if p not in SHED_POLICIES:
                raise ValueError(
                    f"unknown shed policy '{p}' — expected one of "
                    f"{SHED_POLICIES}")


@guarded
class FairScheduler:
    """Weighted fair throttling across registered apps.

    Each delivery charges its app's decayed usage (events, time constant
    ``tau_s``); ``throttle`` sleeps a worker briefly when its app's share
    of the total recent usage exceeds its weighted fair share while a
    SIBLING app has backlog. With fewer than two registered apps, or no
    sibling backlog, it never sleeps."""

    _SLACK = 1.25            # tolerated overshoot before throttling
    _MAX_SLEEP_S = 0.02      # the longest yield of one call

    GUARDED_BY = {"_apps": "overload"}

    def __init__(self, tau_s: float = 1.0):
        self.tau_s = float(tau_s)
        self._lock = make_lock("overload")
        # name -> {"weight", "usage", "last", "backlog_fn"}
        self._apps: Dict[str, dict] = {}

    def register(self, name: str, weight: float, backlog_fn) -> None:
        with self._lock:
            self._apps[name] = {"weight": max(float(weight), 1e-6),
                                "usage": 0.0, "last": time.monotonic(),
                                "backlog_fn": backlog_fn}

    def unregister(self, name: str) -> None:
        with self._lock:
            self._apps.pop(name, None)

    def _decayed(self, st: dict, now: float) -> float:
        dt = now - st["last"]
        return st["usage"] * math.exp(-dt / self.tau_s) if dt > 0 else st["usage"]

    def throttle(self, name: str, units: int) -> float:
        """Charge ``units`` to ``name`` and return (after sleeping) the
        yield this call paid, in seconds."""
        now = time.monotonic()
        delay = 0.0
        with self._lock:
            st = self._apps.get(name)
            if st is None:
                return 0.0
            st["usage"] = self._decayed(st, now) + float(units)
            st["last"] = now
            if len(self._apps) >= 2:
                total_u = total_w = 0.0
                others_backlogged = False
                for n, s in self._apps.items():
                    total_u += self._decayed(s, now)
                    total_w += s["weight"]
                    if n != name and not others_backlogged:
                        try:
                            others_backlogged = bool(s["backlog_fn"]())
                        except Exception:  # noqa: BLE001 — a dead app's probe
                            pass
                if total_u > 0 and others_backlogged:
                    share = st["usage"] / total_u
                    fair = st["weight"] / total_w
                    if share > fair * self._SLACK:
                        delay = min(self._MAX_SLEEP_S, 0.005 * share / fair)
        if delay:
            time.sleep(delay)
        return delay


@guarded
class AppOverloadControl:
    """One registered app's overload state: queue admission for its
    junctions, the memory ledger, and the shed and denial counts.
    Installed as ``app_context.overload`` by ``OverloadManager.register``;
    every call site takes ``None`` as "no quotas"."""

    # the counters are written under the lock and read without it
    GUARDED_BY = {"_ledger": "overload"}

    def __init__(self, manager: "OverloadManager", app_runtime,
                 config: OverloadConfig):
        self.manager = manager
        self.app_runtime = app_runtime
        self.app_context = app_runtime.app_context
        self.config = config
        self._lock = make_lock("overload")
        # component -> charged bytes (the capacity-growth ledger)
        self._ledger: Dict[str, int] = {}
        self.shed_events = 0          # events shed across all streams
        self.shed_units = 0           # queue units shed
        self.quota_denials = 0        # memory-budget growth denials
        self.enqueue_timeouts = 0     # block-policy escalations

    # ------------------------------------------------------------- lookup

    @property
    def name(self) -> str:
        return self.app_context.name

    @property
    def pipeline_quota(self) -> Optional[int]:
        return self.config.pipeline_quota

    @property
    def memory_budget_bytes(self) -> Optional[int]:
        return self.config.memory_budget_bytes

    @property
    def query_cap(self) -> Optional[int]:
        return self.config.query_cap

    @property
    def block_timeout_s(self) -> float:
        return self.config.block_timeout_s

    def queue_quota_of(self, junction) -> Optional[int]:
        q = self.config.queue_quota_per_stream.get(junction.definition.id)
        return q if q is not None else self.config.queue_quota

    def policy_of(self, junction) -> str:
        return self.config.shed_policy_per_stream.get(
            junction.definition.id, self.config.shed_policy)

    # ---------------------------------------------------------- admission

    def admit(self, junction, item, wal_seq=None) -> bool:
        """Queue admission of one @Async enqueue. False when the unit was
        SHED (counted, its WAL record discarded): the junction must not
        enqueue it. ``block`` returns True after a bounded wait that
        escalates to the supervisor every ``block_timeout_s``."""
        quota = self.queue_quota_of(junction)
        if quota is None:
            return True
        q = junction._queue
        if q is None or q.qsize() < quota:
            return True
        wal = getattr(self.app_context, "ingest_wal", None)
        if wal is not None and wal.in_replay():
            # a WAL replay re-feeds the accepted suffix: shedding it again
            # would break the effectively-once restore
            return True
        policy = self.policy_of(junction)
        if policy == "shed_newest":
            self._record_shed(junction, _units(item), wal_seq, wal)
            return False
        if policy == "shed_oldest":
            while q.qsize() >= quota:
                try:
                    old = q.get_nowait()
                except queue.Empty:
                    break
                if old is None:
                    # the stop sentinel mid-shutdown: keep it and shed the
                    # incoming unit (the worker is about to exit)
                    try:
                        q.put_nowait(None)
                    except queue.Full:
                        pass
                    self._record_shed(junction, _units(item), wal_seq, wal)
                    return False
                # the evicted unit's WAL seq and journey stamp go with it
                seq = junction._forget_unit(old)
                self._record_shed(junction, _units(old), seq, wal)
            return True
        # block: a bounded wait below the quota, escalating each timeout
        waited = 0.0
        while q.qsize() >= quota:
            if junction._fatal is not None:
                raise junction._fatal
            if not junction._running:
                return True          # shutdown: the put path decides
            time.sleep(_WAIT_SLICE_S)
            waited += _WAIT_SLICE_S
            if waited >= self.config.block_timeout_s:
                waited = 0.0
                self.escalate(junction)
        return True

    def _record_shed(self, junction, n_events: int, wal_seq, wal) -> None:
        from siddhi_tpu_torch.resilience import stat_count

        if wal is not None and wal_seq is not None:
            # never processed: a restore must replay exactly the suffix
            # that was not shed
            wal.discard(wal_seq)
        with self._lock:
            self.shed_events += n_events
            self.shed_units += 1
        tel = getattr(self.app_context, "telemetry", None)
        if tel is not None:
            tel.count(f"junction.{junction.definition.id}.shed_events", n_events)
        stat_count(self.app_context, "resilience.shed_events", n_events)

    def escalate(self, junction) -> None:
        """A producer made no progress for ``block_timeout_s``: count it
        and hand the junction to the supervisor, which replaces a dead or
        beat-stalled consumer."""
        from siddhi_tpu_torch.resilience import stat_count

        with self._lock:
            self.enqueue_timeouts += 1
        sid = junction.definition.id
        tel = getattr(self.app_context, "telemetry", None)
        if tel is not None:
            tel.count(f"junction.{sid}.enqueue_timeouts")
        stat_count(self.app_context, "resilience.enqueue_timeouts")
        sup = getattr(self.app_context, "supervisor", None)
        if sup is not None:
            try:
                sup.notify_backpressure(junction)
            except Exception:  # noqa: BLE001 — escalation must not mask
                log.exception("backpressure escalation failed")
        else:
            log.warning(
                "producer blocked on full queue of junction '%s' for "
                "%.1fs and no supervisor is attached — call "
                "rt.supervise() so a wedged consumer can be replaced",
                sid, self.config.block_timeout_s)

    # ------------------------------------------------------ memory budget

    def charged_bytes(self) -> int:
        with self._lock:
            return sum(self._ledger.values())

    def charge(self, component: str, nbytes: int) -> None:
        with self._lock:
            self._ledger[component] = max(int(nbytes), 0)

    def ensure_budget(self, component: str, projected_bytes: int,
                      what: str) -> None:
        """Deny growth past the budget with a ``FatalQueryError`` naming
        the knob, before anything is allocated."""
        budget = self.config.memory_budget_bytes
        if budget is None:
            return
        with self._lock:
            used_others = sum(v for k, v in self._ledger.items() if k != component)
        total = used_others + max(int(projected_bytes), 0)
        if total <= budget:
            return
        from siddhi_tpu_torch.core.stream.junction import FatalQueryError
        from siddhi_tpu_torch.resilience import stat_count

        with self._lock:
            self.quota_denials += 1
        tel = getattr(self.app_context, "telemetry", None)
        if tel is not None:
            tel.count("overload.quota_denials")
        stat_count(self.app_context, "resilience.quota_denials")
        raise FatalQueryError(
            f"app '{self.name}': {what} denied — device-memory budget "
            f"exhausted ({component} needs {int(projected_bytes)} B, "
            f"{used_others} B already charged elsewhere, budget "
            f"{budget} B) — raise siddhi_tpu.quota_memory_mb "
            f"(enable_overload(memory_budget_mb=...))")

    # ----------------------------------------------------- fair scheduling

    def throttle(self, units: int) -> None:
        self.manager.fair.throttle(self.name, units)

    def backlog(self) -> int:
        """Queued @Async units across the app's junctions (the fair
        scheduler's are-siblings-starving probe)."""
        total = 0
        for j in self.app_runtime.junctions.values():
            q = getattr(j, "_queue", None)
            if q is not None:
                total += q.qsize()
        return total

    # ------------------------------------------------------------ gauges

    def utilization(self) -> Dict[str, float]:
        # presence, not truthiness: a quota of 0 is enforced and reads as
        # saturated the moment anything is in use
        out = {}
        pq = self.config.pipeline_quota
        if pq is not None:
            pump = getattr(self.app_context, "completion_pump", None)
            n = pump._n_pending if pump is not None else 0
            out["pipeline"] = n / pq if pq > 0 else float(n > 0)
        budget = self.config.memory_budget_bytes
        if budget is not None:
            c = self.charged_bytes()
            out["memory"] = c / budget if budget > 0 else float(c > 0)
        return out


@guarded
class OverloadManager:
    """The process's registry of overload-controlled apps (one a
    process, like the serving tier's scatter pool)."""

    _inst: Optional["OverloadManager"] = None
    _inst_lock = threading.Lock()

    GUARDED_BY = {"_apps": "overload"}

    def __init__(self):
        self._lock = make_lock("overload")
        self._apps: Dict[str, AppOverloadControl] = {}
        self.fair = FairScheduler()

    @classmethod
    def instance(cls) -> "OverloadManager":
        with cls._inst_lock:
            if cls._inst is None:
                cls._inst = OverloadManager()
            return cls._inst

    def register(self, app_runtime, config: OverloadConfig) -> AppOverloadControl:
        """Install quota control on ``app_runtime``. A second register of
        the same runtime replaces the config and keeps the counters."""
        name = app_runtime.app_context.name
        with self._lock:
            ctl = self._apps.get(name)
            if ctl is not None and ctl.app_context is app_runtime.app_context:
                ctl.config = config
            else:
                ctl = AppOverloadControl(self, app_runtime, config)
                self._apps[name] = ctl
        app_runtime.app_context.overload = ctl
        self.fair.register(name, config.fair_weight, ctl.backlog)
        self._register_gauges(ctl)
        return ctl

    def unregister(self, name: str, ctl=None) -> None:
        """Drop a registration. ``ctl`` pins the expected control: a newer
        app registered under the same name keeps its registration when
        the old app shuts down."""
        with self._lock:
            cur = self._apps.get(name)
            if cur is None or (ctl is not None and cur is not ctl):
                cur = None
            else:
                del self._apps[name]
        if cur is None:
            return
        self.fair.unregister(name)
        if getattr(cur.app_context, "overload", None) is cur:
            cur.app_context.overload = None

    def control_of(self, name: str) -> Optional[AppOverloadControl]:
        with self._lock:
            return self._apps.get(name)

    def _register_gauges(self, ctl: AppOverloadControl) -> None:
        """The app's quota-utilization gauges (``GET /metrics`` renders
        them as ``siddhi_quota_utilization{app,resource[,stream]}``)."""
        tel = getattr(ctl.app_context, "telemetry", None)
        if tel is None:
            return
        cfg = ctl.config
        for sid, j in ctl.app_runtime.junctions.items():
            # presence, not truthiness: a per-stream quota of 0 is enforced
            quota = cfg.queue_quota_per_stream.get(sid)
            if quota is None:
                quota = cfg.queue_quota
            if quota is not None and getattr(j, "_queue", None) is not None:
                tel.gauge(
                    f"quota.queue_utilization.{sid}",
                    lambda jn=j, q=quota: (
                        (jn._queue.qsize() / q if q > 0
                         else float(jn._queue.qsize() > 0))
                        if jn._queue is not None else 0.0))
        if cfg.pipeline_quota is not None:
            pump = getattr(ctl.app_context, "completion_pump", None)
            if pump is not None:
                tel.gauge("quota.pipeline_utilization",
                          lambda p=pump, q=cfg.pipeline_quota:
                          (p._n_pending / q if q > 0 else float(p._n_pending > 0)))
        if cfg.memory_budget_bytes is not None:
            tel.gauge("quota.memory_utilization",
                      lambda c=ctl, b=cfg.memory_budget_bytes:
                      (c.charged_bytes() / b if b > 0
                       else float(c.charged_bytes() > 0)))


# --------------------------------------------------- call-site helpers
# The growth sites call these, so an app without quotas pays one getattr.

def ensure_memory_budget(app_context, component: str, projected_bytes: int,
                         what: str) -> None:
    """The budget gate of a capacity-growth site: raises
    ``FatalQueryError`` naming ``siddhi_tpu.quota_memory_mb`` when growing
    ``component`` to ``projected_bytes`` would pass the app's budget."""
    ctl = getattr(app_context, "overload", None)
    if ctl is None:
        return
    ctl.ensure_budget(component, projected_bytes, what)


def charge_memory(app_context, component: str, nbytes: int) -> None:
    """Record ``component``'s footprint in the app's ledger, after a
    growth happened."""
    ctl = getattr(app_context, "overload", None)
    if ctl is None:
        return
    ctl.charge(component, nbytes)
