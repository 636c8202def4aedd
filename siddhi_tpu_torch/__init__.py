"""siddhi_tpu_torch: the PyTorch and CUDA port of siddhi_tpu.

The JAX package ``siddhi_tpu`` is the reference this package is held
against; the two share no code (this package imports neither ``jax`` nor
``siddhi_tpu``). Module paths mirror the reference's, so
``siddhi_tpu_torch/core/query/runtime.py`` answers to
``siddhi_tpu/core/query/runtime.py``.

Entry points run on the CUDA card unless the caller asks for another
device::

    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    m = SiddhiManager()                 # cuda; SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(app_text)

Ported so far: single-stream queries with filters and a length window
(per key inside a value partition, or over the whole stream, fused into
invertible aggregators where the reference fuses it), every aggregator
(distinctCount and unionSet through a hand-written CUDA scan,
``ops/distinct.py``), set-valued attributes, the expression function
library and extension functions, stream and query callbacks, and
``device_route_query_step`` over n logical shards on one card with the
shard exchange as a hand-written CUDA kernel (``ops/exchange.py``); every
window, partitions, patterns and sequences, joins, tables, named windows,
on-demand queries and triggers; incremental aggregations
(``core/aggregation/``); and snapshots with persistence
(``core/util/snapshot.py``, ``core/util/persistence.py``); the semantic
fuzzer (``python -m siddhi_tpu_torch.fuzz``) and the runtime sanitizers
(``SIDDHI_TPU_SANITIZE=1``, ``analysis/sanitize.py``).
"""

# SIDDHI_TPU_SANITIZE=1 arms the runtime sanitizers (the host-pull guard,
# the recapture watchdog, the lock-order and guarded-by checks:
# analysis/sanitize.py). It patches a class only: CUDA is not initialized
# here.
from siddhi_tpu_torch.analysis import sanitize as _sanitize

if _sanitize.enabled():
    _sanitize.enable()

from siddhi_tpu_torch.compiler import SiddhiCompiler  # noqa: E402
from siddhi_tpu_torch.core.event import Event  # noqa: E402
from siddhi_tpu_torch.core.manager import SiddhiManager  # noqa: E402
from siddhi_tpu_torch.core.query.callback import QueryCallback  # noqa: E402
from siddhi_tpu_torch.core.stream.output.stream_callback import StreamCallback  # noqa: E402
from siddhi_tpu_torch.core.util.config import InMemoryConfigManager  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Event", "InMemoryConfigManager", "QueryCallback", "SiddhiCompiler",
           "SiddhiManager", "StreamCallback", "__version__"]
