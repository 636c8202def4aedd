"""Semantic fuzzing: a typed SiddhiQL generator + cross-strategy
equivalence hunter with shrinking.

Counterpart of ``siddhi_tpu/fuzz/``. The engine runs one query under
several execution strategies (legacy / fused fan-out / pipelined /
device-routed / device joins) across shard counts, pipeline depths, join
partition counts and ingest pool sizes — all of which must be
**observationally interchangeable**: same app, same input, bit-identical
output in the identical order, within one package on one device.

Modules:

- :mod:`siddhi_tpu_torch.fuzz.determinism` — the deterministic-time
  window discipline every differential check follows;
- :mod:`siddhi_tpu_torch.fuzz.schema` — typed stream/query/case specs
  that render to SiddhiQL and round-trip through JSON (the reference's
  text and JSON, byte for byte);
- :mod:`siddhi_tpu_torch.fuzz.generator` — the seeded typed generator
  (a seed gives the reference's corpus);
- :mod:`siddhi_tpu_torch.fuzz.runner` — the strategy-matrix differential
  runner and the eligibility-census audit, on the card unless the caller
  names another device;
- :mod:`siddhi_tpu_torch.fuzz.shrink` — divergence reduction to a
  minimal repro, written in the reference's fixture format.

Entry point: ``python -m siddhi_tpu_torch.fuzz`` (seeded, budgeted, JSON
report; ``--device`` picks the device).
"""

from siddhi_tpu_torch.fuzz.generator import CaseGenerator  # noqa: F401
from siddhi_tpu_torch.fuzz.runner import (  # noqa: F401
    DiffReport,
    StrategyCombo,
    diff_outputs,
    run_case,
)
from siddhi_tpu_torch.fuzz.schema import CaseSpec, QuerySpec, StreamSpec  # noqa: F401
from siddhi_tpu_torch.fuzz.shrink import shrink_case  # noqa: F401
