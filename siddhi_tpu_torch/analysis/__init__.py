"""Static analysis + runtime sanitizers for the engine's own bug classes.

Counterpart of ``siddhi_tpu/analysis/``:

- ``engine``/``rules_*`` — graftlint: an AST lint suite (R1 no CUDA
  init or tensor at import, R2 ad-hoc config-knob reads, R3
  metric-registration parity, R4 lock order, R5 host pulls in captured
  step code, R6 instrument parity, R7 actuator parity, R8 guarded-by
  lock coverage). Command line: ``python -m siddhi_tpu_torch.analysis``.
  The engine and the rules import the standard library only.
- ``lockorder`` — the declared lock partial order (ranks and edges);
- ``locks`` — ``make_lock(rank)``: a plain RLock normally, the
  order-asserting ``CheckedRLock`` under ``SIDDHI_TPU_SANITIZE=1``;
- ``guards`` — ``GUARDED_BY`` lock-coverage contracts: descriptor-checked
  field access under sanitize, plain attributes off;
- ``sanitize`` — the ``SIDDHI_TPU_SANITIZE=1`` detectors (the host-pull
  guard on ``torch.Tensor``, the recapture watchdog, and the two lock
  checks above);
- ``step_registry`` — the declarative list of every step builder.
"""

from siddhi_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    LintContext,
    ModuleInfo,
    Rule,
    default_rules,
    load_modules,
    run_lint,
)
from siddhi_tpu_torch.analysis.guards import guarded  # noqa: F401
from siddhi_tpu_torch.analysis.locks import make_lock  # noqa: F401
