"""Triggers: ``define trigger T at ('start' | every <time> | '<cron>')``.

Counterpart of ``siddhi_tpu/core/trigger/trigger.py``, the mirror of
reference ``core/trigger/{StartTrigger,PeriodicTrigger.java:36,
CronTrigger.java:46}``: a trigger defines a stream ``T (triggered_time
long)`` and publishes one event per firing. Cron triggers evaluate their
next fire time with the same Quartz-subset schedule the cron window uses
(``ops/host_windows.CronSchedule``) and chain through the scheduler.
"""

from __future__ import annotations

from siddhi_tpu_torch.core.event import Event
from siddhi_tpu_torch.query_api.definitions import TriggerDefinition


class TriggerRuntime:
    def __init__(self, definition: TriggerDefinition, junction, app_context,
                 barrier=None):
        self.definition = definition
        self.junction = junction
        self.app_context = app_context
        self._barrier = barrier  # the app's quiesce gate (InputEntryValve role)
        self._job = None
        self._cron = None
        self._stopped = False
        if definition.cron is not None:
            from siddhi_tpu_torch.ops.host_windows import CronSchedule

            self._cron = CronSchedule(definition.cron)

    def start(self):
        scheduler = self.app_context.scheduler
        if self.definition.at_start:
            ts = self.app_context.timestamp_generator.current_time()
            self._fire(ts)
        elif self.definition.at_every is not None and scheduler is not None:
            self._job = scheduler.schedule_periodic(self.definition.at_every, self._fire)
        elif self._cron is not None and scheduler is not None:
            now = int(self.app_context.timestamp_generator.current_time())
            scheduler.notify_at(self._cron.next_fire(now), self._cron_fire)

    def stop(self):
        self._stopped = True
        if self._job is not None and self.app_context.scheduler is not None:
            self.app_context.scheduler.cancel(self._job)
            self._job = None

    def _cron_fire(self, ts: int):
        if self._stopped:
            return
        self._fire(ts)
        scheduler = self.app_context.scheduler
        if scheduler is not None:
            scheduler.notify_at(self._cron.next_fire(int(ts)), self._cron_fire)

    def _fire(self, ts: int):
        events = [Event(timestamp=int(ts), data=[int(ts)])]
        if self._barrier is not None:
            with self._barrier:
                self.junction.send_events(events)
        else:
            self.junction.send_events(events)
