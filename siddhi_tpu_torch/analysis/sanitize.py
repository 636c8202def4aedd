"""Runtime sanitizers, gated by ``SIDDHI_TPU_SANITIZE=1``.

Counterpart of ``siddhi_tpu/analysis/sanitize.py``. Four detectors for
the engine's own bug classes, armed at runtime so tests and soaks catch
what review misses:

1. **Host-pull guard.** ``enable()`` patches ``torch.Tensor``'s scalar
   coercions (``float()``/``int()``/``bool()``/``.item()``, the
   reference's pattern set) to raise ``HostPullError`` outside an
   ``allowed_pull()`` scope. It acts on CPU tensors as on the card's, so
   a CPU test shows what a run on the card would trip. The sanctioned
   batched pulls stay allowed: ``.cpu()``, ``.tolist()``, ``.numpy()``
   (``LazyColumns``' one device-to-host copy, the pump's meta pull). It
   is not ``torch.cuda.set_sync_debug_mode``: that flags the sanctioned
   explicit pulls as well, so it is no counterpart of jax's
   ``transfer_guard("disallow")``.

2. **Recapture watchdog.** A step's "compile" in the port is building
   the step plus, on the card, capturing its CUDA graph; a capturable
   step run eagerly (on the CPU) counts one for each new input spec (the
   shapes and dtypes it is called with), the spec its graph would be
   captured for on the card. A step that is not capturable is built once
   and never captured. ``InstrumentedJit``
   (observability/telemetry.py) counts its compiles and, through the
   hook it gives ``StepGraph.run`` (core/query/step_graph.py), is asked
   before every capture; once a key passes its budget
   (``SIDDHI_TPU_SANITIZE_MAX_COMPILES``, default 8) or ANY compile
   comes after ``freeze_compiles()``, a ``RecompileError`` names the
   key. A program-cache hit builds and captures nothing, so it counts
   nothing; each app's step (a re-install by ``route_shards``, the
   fuzzer's per-combo app) counts against its own instrument.

3. **Lock-order assertions.** ``analysis.locks.make_lock`` returns
   ``CheckedRLock``s that enforce the partial order declared in
   ``analysis/lockorder.py`` per thread, per acquisition.

4. **Lock-coverage (guarded-by) assertions.** ``analysis.guards``
   installs a data descriptor per field a class declares in its
   ``GUARDED_BY`` map: every read/write asserts, through the
   ``CheckedRLock`` per-thread holdings, that a lock of the guarding rank
   is held, raising ``GuardViolation`` otherwise. Plain attributes when
   off.

Set ``SIDDHI_TPU_SANITIZE=1`` in the environment BEFORE importing
siddhi_tpu_torch (the lock factory, the guarded classes and the step
instruments read it at construction); the package arms the pull guard
at import then. Arming configures only: it never initializes CUDA.
"""

from __future__ import annotations

import os
import threading

_ENV = "SIDDHI_TPU_SANITIZE"
_ENV_MAX_COMPILES = "SIDDHI_TPU_SANITIZE_MAX_COMPILES"


class HostPullError(RuntimeError):
    """A tensor was coerced to a host scalar outside a sanctioned pull
    site (the no-host-pull-in-hot-path bug class)."""


class RecompileError(RuntimeError):
    """A step was built or captured past its warm-up budget."""


def enabled() -> bool:
    return os.environ.get(_ENV, "").strip().lower() in ("1", "true", "on",
                                                        "yes")


def max_compiles() -> int:
    # typed read: a junk spelling raises naming the variable instead of
    # silently falling back to the default
    from siddhi_tpu_torch.core.util.knobs import env_knob

    return env_knob(_ENV_MAX_COMPILES, "int", 8)


# ----------------------------------------------------------- pull guard

_TLS = threading.local()
_PATCHED = [False]
_GUARDED = ("__float__", "__int__", "__bool__", "item")


class allowed_pull:
    """Scope marker for sanctioned host pulls (snapshot capture, test
    assertions): scalar coercions inside do not raise."""

    def __enter__(self):
        _TLS.depth = getattr(_TLS, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _TLS.depth -= 1
        return False


def _pull_allowed() -> bool:
    return getattr(_TLS, "depth", 0) > 0


def _install_pull_guard() -> None:
    """Patch ``torch.Tensor``'s scalar coercions to raise outside
    ``allowed_pull()`` while ``enabled()``. The batched pulls
    (``.cpu()``, ``.tolist()``, ``.numpy()``, ``np.asarray``) are
    untouched."""
    if _PATCHED[0]:
        return
    import torch

    cls = torch.Tensor
    for name in _GUARDED:
        orig = getattr(cls, name)

        def guard(self, *args, __orig=orig, __name=name, **kw):
            # enabled() re-checked per call: the patch is process-wide
            # and must go inert when a test unsets the env var
            if enabled() and not _pull_allowed():
                raise HostPullError(
                    f"sanitizer: host pull via {__name}() on a {self.device} "
                    f"tensor outside a sanctioned pull site — batch the "
                    f"transfer through .cpu()/.tolist() (or wrap a cold-"
                    f"path read in analysis.sanitize.allowed_pull())")
            return __orig(self, *args, **kw)

        setattr(cls, name, guard)
    _PATCHED[0] = True


# ------------------------------------------------------ recompile guard

_FROZEN = [False]


def freeze_compiles() -> None:
    """Declare warm-up over: from now on ANY step build or capture raises
    ``RecompileError`` naming the key."""
    _FROZEN[0] = True


def thaw_compiles() -> None:
    _FROZEN[0] = False


def compiles_frozen() -> bool:
    return _FROZEN[0]


def check_recompile(key: str, compiles: int) -> None:
    """Called by a step instrument (``InstrumentedJit``) when the step is
    about to be built or captured again. Raises past the per-key budget or
    after a freeze."""
    if not enabled():
        # an instrument built while sanitize was on keeps its watch, but
        # after disable()/env-unset the watchdog must go inert like the
        # pull guard does
        return
    if _FROZEN[0]:
        raise RecompileError(
            f"sanitizer: step key '{key}' recompiled after warmup "
            f"(freeze_compiles() active; compile #{compiles})")
    budget = max_compiles()
    if compiles > budget:
        raise RecompileError(
            f"sanitizer: step key '{key}' compiled {compiles} times — "
            f"past the {_ENV_MAX_COMPILES}={budget} budget; a compile "
            f"per batch means a shape or dtype is not stabilizing "
            f"(check the pow2 padding of the batch columns)")


# --------------------------------------------------------------- enable

def enable() -> None:
    """Arm every sanitizer this process supports. Idempotent; called at
    ``siddhi_tpu_torch`` import when ``SIDDHI_TPU_SANITIZE=1``. Patches a
    class only: no CUDA initialization."""
    _install_pull_guard()


def disable() -> None:
    """Thaw the watchdog (tests that enable() mid-process call this in
    teardown; the pull-guard patch needs no undo — it re-checks
    ``enabled()`` per call and goes inert with the env var)."""
    thaw_compiles()
