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
shard exchange as a hand-written CUDA kernel (``ops/exchange.py``).
"""

from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.event import Event
from siddhi_tpu_torch.core.manager import SiddhiManager
from siddhi_tpu_torch.core.query.callback import QueryCallback
from siddhi_tpu_torch.core.stream.output.stream_callback import StreamCallback
from siddhi_tpu_torch.core.util.config import InMemoryConfigManager

__all__ = ["Event", "InMemoryConfigManager", "QueryCallback", "SiddhiCompiler",
           "SiddhiManager", "StreamCallback"]
