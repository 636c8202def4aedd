"""Runtime sanitizers and lock contracts for the engine's own bug classes.

Counterpart of ``siddhi_tpu/analysis/`` (its runtime half):

- ``lockorder`` — the declared lock partial order (ranks and edges);
- ``locks`` — ``make_lock(rank)``: a plain RLock normally, the
  order-asserting ``CheckedRLock`` under ``SIDDHI_TPU_SANITIZE=1``;
- ``guards`` — ``GUARDED_BY`` lock-coverage contracts: descriptor-checked
  field access under sanitize, plain attributes off;
- ``sanitize`` — the ``SIDDHI_TPU_SANITIZE=1`` detectors (the host-pull
  guard on ``torch.Tensor``, the recapture watchdog, and the two lock
  checks above);
- ``step_registry`` — the declarative list of every step builder.

The reference's static half (the lint engine and its ``rules_*.py``) is
ROADMAP A.10 f, static half.
"""
