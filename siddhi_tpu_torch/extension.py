"""Public extension surface.

Counterpart of ``siddhi_tpu/extension.py`` for the kinds the port runs.
Register an implementation with ``SiddhiManager.set_extension(name, cls)``;
kinds:

- ``function:<name>`` (or ``function:<namespace>:<name>``) — a
  :class:`ScalarFunction`;
- ``source:<type>`` / ``sink:<type>`` — transports;
- ``sourceMapper:<type>`` / ``sinkMapper:<type>`` — payload mappers.

A bare name matches any kind. Stream functions wait for their module.
"""

from __future__ import annotations

from siddhi_tpu_torch.core.stream.input.source import (  # noqa: F401
    ConnectionUnavailableException,
    Source,
    SourceMapper,
)
from siddhi_tpu_torch.core.stream.output.sink import Sink, SinkMapper  # noqa: F401
from siddhi_tpu_torch.core.util.transport import InMemoryBroker  # noqa: F401


class ScalarFunction:
    """Custom scalar function over columns: set ``return_type`` to an
    ``AttrType`` (or a callable of the argument types) and implement
    ``apply(xp, *arrays)``, one vectorized call per batch instead of the
    reference's per-event ``FunctionExecutor.execute``.

    ``xp`` is the port's array namespace (``ops/expressions.TorchXP`` in a
    query step, ``NUMPY_XP`` where keys are computed on the host). The
    arrays are torch tensors on the app's device in a step (numpy arrays
    on the host, numpy or Python scalars for constants); arithmetic
    operators work on all of them, and ``xp`` offers the numpy-named calls
    ``asarray``, ``where``, ``maximum``, ``minimum``, ``sqrt``, ``abs``,
    ``sign``, ``fmod``, ``sum(v, axis=None, dtype=None)``, ``zeros``,
    ``ones``, ``full``, ``zeros_like``, ``ones_like`` and the dtypes
    ``xp.int32``, ``xp.int64``, ``xp.float32``, ``xp.float64``,
    ``xp.bool_``. String arguments arrive as dictionary ids."""

    return_type = None

    @staticmethod
    def apply(xp, *args):  # pragma: no cover - interface
        raise NotImplementedError
