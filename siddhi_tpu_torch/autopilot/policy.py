"""Rule/hysteresis policy layer: named bottleneck -> bounded knob delta.

Counterpart of ``siddhi_tpu/autopilot/policy.py``: the same six rules and
the same hysteresis, so one snapshot gets one verdict in both packages.
Plain rules, deliberately so: each :class:`PolicyRule` names the ONE
declared actuator it may drive and inspects only the read-only
:class:`~siddhi_tpu_torch.autopilot.signals.SignalSnapshot`. The hysteresis machinery wrapping the rules is what
keeps a closed loop from chewing on itself:

- **cooldown**: after a knob moves, it holds still for
  ``autopilot_cooldown_s`` seconds;
- **oscillation damping**: a rule wanting to REVERSE a knob's last
  direction within two cooldown windows is suppressed (logged with
  ``applied=False`` so the flapping is auditable, not silent);
- **compile-storm backoff**: while the app's summed compile count (step
  builds and, on the card, graph captures) is climbing between ticks,
  ALL actuation freezes: re-steering an engine that is busy re-capturing
  only feeds the storm.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from siddhi_tpu_torch.autopilot.actuators import ACTUATORS, DOWN, UP
from siddhi_tpu_torch.autopilot.signals import SignalSnapshot


@dataclass(frozen=True)
class PolicyRule:
    """One observation->direction mapping. ``when(sig)`` returns "up",
    "down" or None; ``name`` is the reason tag on the decision log and
    the ``siddhi_autopilot_decisions_total{reason=...}`` label."""

    name: str
    actuator: str
    when: Optional[Callable[[SignalSnapshot], Optional[str]]] = None


@dataclass
class Decision:
    """One policy verdict (logged even when damping/dry_run stops it)."""

    seq: int
    t: float
    app: str
    actuator: str
    knob: str            # the actuator's typed-knob key
    direction: str
    reason: str
    applied: bool = False
    old: Optional[int] = None
    new: Optional[int] = None

    def as_dict(self) -> dict:
        d = {"seq": self.seq, "t": round(self.t, 3), "app": self.app,
             "actuator": self.actuator, "knob": self.knob,
             "direction": self.direction, "reason": self.reason,
             "applied": self.applied}
        if self.old is not None:
            d["old"] = self.old
            d["new"] = self.new
        return d


def _device_bound(sig: SignalSnapshot) -> Optional[str]:
    b = sig.worst_bottleneck()
    if b is None:
        return None
    if b.get("stage") == "device" and (b.get("utilization") or 0) >= 0.5 \
            and sig.pipeline_depth < 8:
        return UP            # more overlap hides device latency
    if (b.get("utilization") or 0) < 0.15 and sig.pipeline_depth > 2:
        return DOWN          # pipeline deeper than the load needs
    return None


def _pack_bound(sig: SignalSnapshot) -> Optional[str]:
    b = sig.worst_bottleneck()
    if b is not None and b.get("stage") == "pack" \
            and (b.get("utilization") or 0) >= 0.3:
        return UP            # shard pack/encode across more workers
    if sig.pool_workers is not None and sig.pool_workers > 1 \
            and sig.pool_utilization < 0.2 \
            and (b is None or b.get("stage") != "pack"):
        return DOWN          # pool idling: hand the cores back
    return None


def _join_overprovisioned(sig: SignalSnapshot) -> Optional[str]:
    return DOWN if sig.join_shrinkable else None


def _shard_pressure(sig: SignalSnapshot) -> Optional[str]:
    if not sig.routed:
        return None
    b = sig.worst_bottleneck()
    if b is None:
        return None
    if b.get("stage") == "device" and (b.get("utilization") or 0) >= 0.9:
        return UP            # spread keys across more shards
    if (b.get("utilization") or 0) < 0.05 and max(sig.routed.values()) > 2:
        return DOWN          # exchange overhead for idle shards
    return None


def _queue_pressure(sig: SignalSnapshot) -> Optional[str]:
    qs = [v for k, v in sig.quota.items()
          if k.startswith("queue_utilization")]
    if not qs:
        return None
    if max(qs) >= 0.9:
        return DOWN          # shed earlier: protect latency over admission
    if max(qs) < 0.3:
        return UP            # pressure cleared: relax back toward config
    return None


def _fusion_churn(sig: SignalSnapshot) -> Optional[str]:
    b = sig.worst_bottleneck()
    if sig.fused_groups == 0 and b is not None \
            and b.get("stage") == "dispatch" \
            and (b.get("utilization") or 0) >= 0.5:
        return UP            # per-query dispatch overhead: re-form groups
    return None


# ONE rule per actuation path; each names its actuator literally
RULES = (
    PolicyRule(name="device_bound", actuator="pipeline_depth",
               when=_device_bound),
    PolicyRule(name="pack_bound", actuator="ingest_pool",
               when=_pack_bound),
    PolicyRule(name="join_overprovisioned", actuator="join_partitions",
               when=_join_overprovisioned),
    PolicyRule(name="shard_pressure", actuator="route_shards",
               when=_shard_pressure),
    PolicyRule(name="queue_pressure", actuator="admission_cap",
               when=_queue_pressure),
    PolicyRule(name="dispatch_bound", actuator="fuse_fanout",
               when=_fusion_churn),
)


@dataclass
class _KnobState:
    last_t: float = -1e18        # monotonic time of last APPLIED move
    last_direction: Optional[str] = None


@dataclass
class Policy:
    """Per-app hysteresis state around the shared RULES table."""

    cooldown_s: float = 5.0
    rules: tuple = RULES
    knobs: Dict[str, _KnobState] = field(default_factory=dict)
    last_jit_compiles: Optional[int] = None
    frozen: bool = False         # compile-storm backoff engaged last tick

    def observe_compiles(self, jit_compiles: int) -> bool:
        """Update the compile-storm detector; True = actuation frozen
        this tick (the summed compile count climbed since the last)."""
        prev, self.last_jit_compiles = self.last_jit_compiles, jit_compiles
        self.frozen = prev is not None and jit_compiles > prev
        return self.frozen

    def decide(self, sig: SignalSnapshot, now: float) -> List[dict]:
        """Run every rule; returns verdicts as
        ``{"rule", "direction", "blocked"}`` — ``blocked`` is None when
        the move may actuate, else "cooldown" / "damped" (the caller
        logs blocked verdicts too; an invisible suppression is how
        oscillation hides)."""
        out = []
        for rule in self.rules:
            direction = rule.when(sig) if rule.when is not None else None
            if direction is None:
                continue
            st = self.knobs.setdefault(rule.actuator, _KnobState())
            blocked = None
            if now - st.last_t < self.cooldown_s:
                blocked = "cooldown"
            elif st.last_direction is not None \
                    and direction != st.last_direction \
                    and now - st.last_t < 2 * self.cooldown_s:
                blocked = "damped"
            out.append({"rule": rule, "direction": direction,
                        "blocked": blocked})
        return out

    def applied(self, actuator: str, direction: str, now: float) -> None:
        st = self.knobs.setdefault(actuator, _KnobState())
        st.last_t = now
        st.last_direction = direction

    def bounds_ok(self, actuator: str, value: int) -> bool:
        a = ACTUATORS[actuator]
        return a.lo <= value <= a.hi
