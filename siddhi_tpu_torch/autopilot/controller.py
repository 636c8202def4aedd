"""The per-process autopilot controller: one thread, many apps.

Counterpart of ``siddhi_tpu/autopilot/controller.py``. The same
process-singleton discipline as ``resilience/overload.py``'s
OverloadManager: ``SiddhiAppRuntime.start()`` registers the app when
``siddhi_tpu.autopilot`` != off, ``shutdown()`` unregisters it
identity-pinned (an old runtime shutting down never strips a newer
same-named app's controller). Each tick per app:

    observe (signals.collect, host reads only)
      -> decide (policy rules under cooldown/damping/compile-backoff)
        -> actuate (mode 'on') or log-only (mode 'dry_run')

Every verdict — applied, damped, cooling down or dry-run — lands in a
bounded per-app decision log (the ``GET /autopilot`` report) and on the
decision counter (``siddhi_autopilot_decisions_total{knob,direction,
reason}`` after export). Ticks also run manually via
``AutopilotController.instance().tick(name)``: tests and chip_smoke.py
drive the loop deterministically that way.

A tick reads host surfaces only (``signals.collect``) and never
synchronizes the card; an actuation runs on the tick's thread, and one
that fails (a re-install refused by the device-memory budget gate, say)
is logged and leaves the decision unapplied: never an engine fault.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.autopilot import signals
from siddhi_tpu_torch.autopilot.actuators import ACTUATORS
from siddhi_tpu_torch.autopilot.policy import Decision, Policy

_LOG = logging.getLogger("siddhi_tpu_torch.autopilot")

DECISION_LOG_CAPACITY = 256
MODE_VALUES = {"off": 0.0, "dry_run": 1.0, "on": 2.0}


class _AppState:
    def __init__(self, rt):
        self.rt = rt
        ctx = rt.app_context
        self.policy = Policy(
            cooldown_s=float(getattr(ctx, "autopilot_cooldown_s", 5.0)))
        self.decisions: deque = deque(maxlen=DECISION_LOG_CAPACITY)
        self.seq = 0
        self.ticks = 0
        self.freezes = 0
        # ticks (thread + manual) on one app serialize on this
        self.lock = make_lock("autopilot")

    @property
    def mode(self) -> str:
        return str(getattr(self.rt.app_context, "autopilot", "off"))

    @property
    def interval_s(self) -> float:
        return float(getattr(self.rt.app_context,
                             "autopilot_interval_s", 0.25) or 0.25)


@guarded
class AutopilotController:
    """Process-wide controller registry + tick thread."""

    _instance: Optional["AutopilotController"] = None
    _instance_lock = threading.Lock()

    GUARDED_BY = {"_apps": "autopilot"}

    def __init__(self):
        self._lock = make_lock("autopilot")
        self._apps: Dict[str, _AppState] = {}
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stopping = False

    @classmethod
    def instance(cls) -> "AutopilotController":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = AutopilotController()
            return cls._instance

    # ------------------------------------------------------ registration

    def register(self, app_runtime) -> _AppState:
        """Idempotent attach; enables journey tracing (refcounted) for
        the app's lifetime — the critical-path report is the
        controller's primary signal."""
        ctx = app_runtime.app_context
        name = ctx.name
        with self._lock:
            st = self._apps.get(name)
            if st is not None and st.rt is app_runtime:
                return st
            if st is not None:
                # a same-named app replaces the registration (blue/green
                # redeploy); the OLD runtime's unregister is pinned to
                # its own state object so it cannot strip this one
                self._release(st)
            from siddhi_tpu_torch.observability import journey

            journey.enable()
            st = _AppState(app_runtime)
            self._apps[name] = st
            tel = getattr(ctx, "telemetry", None)
            if tel is not None:
                tel.gauge("autopilot.mode",
                          lambda s=st: MODE_VALUES.get(s.mode, 0.0))
            self._ensure_thread()
            return st

    def unregister(self, name: str, app_runtime=None) -> None:
        """Identity-pinned: passing ``app_runtime`` only detaches when
        the registration still belongs to that runtime."""
        with self._lock:
            st = self._apps.get(name)
            if st is None:
                return
            if app_runtime is not None and st.rt is not app_runtime:
                return
            del self._apps[name]
            self._release(st)
            if not self._apps:
                self._stop_thread_locked()

    def _release(self, st: _AppState) -> None:
        tel = getattr(st.rt.app_context, "telemetry", None)
        if tel is not None:
            tel.remove_gauge("autopilot.mode")
        from siddhi_tpu_torch.observability import journey

        journey.disable()

    # ------------------------------------------------------- tick thread

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stopping = False
        self._wake.clear()
        self._thread = threading.Thread(
            target=self._run, name="siddhi-autopilot", daemon=True)
        self._thread.start()

    def _stop_thread_locked(self) -> None:
        self._stopping = True
        self._wake.set()
        self._thread = None

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopping or not self._apps:
                    return
                names = list(self._apps)
                interval = min(self._apps[n].interval_s for n in names)
            # wait BEFORE the first tick: a freshly-registered app gets
            # one full interval of undisturbed warmup, and tests driving
            # manual tick(name, now=...) clocks see no thread tick race
            if self._wake.wait(timeout=interval):
                self._wake.clear()
                continue
            for name in names:
                try:
                    self.tick(name)
                except Exception:  # noqa: BLE001 — one bad tick must not
                    # kill the controller for every app in the process
                    _LOG.exception("autopilot tick failed for %s", name)

    # -------------------------------------------------------------- tick

    def tick(self, name: str, now: Optional[float] = None) -> List[dict]:
        """One observe->decide->actuate cycle for one app. Returns the
        decision-log entries appended by this tick."""
        with self._lock:
            st = self._apps.get(name)
        if st is None:
            return []
        mode = st.mode
        if mode == "off":
            return []
        now = time.monotonic() if now is None else now
        with st.lock:
            return self._tick_locked(st, mode, now)

    def _tick_locked(self, st: _AppState, mode: str, now: float) -> List[dict]:
        rt = st.rt
        ctx = rt.app_context
        tel = getattr(ctx, "telemetry", None)
        sig = signals.collect(rt)
        st.ticks += 1
        if tel is not None:
            tel.count("autopilot.ticks")
        if st.policy.observe_compiles(sig.jit_compiles):
            # compile-storm backoff: programs are still compiling —
            # freeze every knob until the count stops climbing
            st.freezes += 1
            if tel is not None:
                tel.count("autopilot.freezes")
            return []
        entries: List[dict] = []
        for verdict in st.policy.decide(sig, now):
            rule, direction = verdict["rule"], verdict["direction"]
            blocked = verdict["blocked"]
            actuator = ACTUATORS[rule.actuator]
            st.seq += 1
            dec = Decision(seq=st.seq, t=now, app=ctx.name,
                           actuator=actuator.name, knob=actuator.knob,
                           direction=direction, reason=rule.name)
            applied_change = None
            if blocked is None and mode == "on" \
                    and actuator.apply is not None:
                try:
                    applied_change = actuator.apply(rt, direction)
                except Exception:  # noqa: BLE001 — a failed actuation is
                    # a logged non-event, never an engine fault
                    _LOG.exception("actuator %s failed on %s",
                                   actuator.name, ctx.name)
            if applied_change is not None:
                dec.applied = True
                dec.old, dec.new = applied_change
                st.policy.applied(actuator.name, direction, now)
            entry = dec.as_dict()
            entry["mode"] = mode
            if blocked is not None:
                entry["blocked"] = blocked
            st.decisions.append(entry)
            entries.append(entry)
            if tel is not None:
                tel.count(f"autopilot.decisions.{actuator.knob}"
                          f".{direction}.{rule.name}")
        return entries

    # ------------------------------------------------------------ report

    def report(self, app: Optional[str] = None) -> dict:
        """The ``GET /autopilot`` body. Raises KeyError for an unknown
        app (the REST layer maps it to 404)."""
        with self._lock:
            states = dict(self._apps)
        if app is not None:
            if app not in states:
                raise KeyError(f"app '{app}' has no autopilot registration")
            states = {app: states[app]}
        apps = {}
        for name in sorted(states):
            st = states[name]
            apps[name] = {
                "mode": st.mode,
                "interval_s": st.interval_s,
                "cooldown_s": st.policy.cooldown_s,
                "frozen": st.policy.frozen,
                "ticks": st.ticks,
                "freezes": st.freezes,
                "decisions": list(st.decisions),
            }
        return {
            "actuators": {
                a.name: {"knob": a.knob, "lo": a.lo, "hi": a.hi,
                         "doc": a.doc}
                for a in ACTUATORS.values()},
            "decision_log_capacity": DECISION_LOG_CAPACITY,
            "apps": apps,
        }
