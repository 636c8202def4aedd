"""Autopilot: a closed-loop controller over the engine's live knobs.

Counterpart of ``siddhi_tpu/autopilot/``. The engine measures a great deal
(critical-path verdicts naming the bottleneck stage,
``observability/journey.py``; device-instrument fills; quota-utilization
gauges; per-step compile counts), and this package closes the
observe -> decide -> actuate loop over the knobs that only change when and
where work runs, never what is emitted:

- ``signals.py``    a read-only snapshot of what the engine already
                    exports: host reads only, no device sync;
- ``policy.py``     the rules and their hysteresis: cooldowns, per-knob
                    bounds, oscillation damping, compile-storm backoff;
- ``actuators.py``  the declared ``ACTUATORS``: six live knobs, each
                    naming its typed knob in ``core/util/knobs.py``;
- ``controller.py`` the process-wide controller thread, the bounded
                    decision log, the ``GET /autopilot`` report and the
                    ``autopilot.*`` telemetry (``siddhi_autopilot_*``).

Gated by the typed knob ``siddhi_tpu.autopilot``: ``off`` (the default)
registers nothing and leaves the engine as it is without this package;
``dry_run`` decides and logs but never actuates.
"""

from siddhi_tpu_torch.autopilot.actuators import ACTUATORS  # noqa: F401
from siddhi_tpu_torch.autopilot.controller import AutopilotController  # noqa: F401
from siddhi_tpu_torch.autopilot.policy import Policy, PolicyRule  # noqa: F401
from siddhi_tpu_torch.autopilot.signals import SignalSnapshot, collect  # noqa: F401
