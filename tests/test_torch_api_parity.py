"""Every public name of the JAX package has a counterpart in the port.

For each public module of ``siddhi_tpu`` (no path component starting with
``_``) the port keeps a module under the same path, and that module has
every public name the reference's module defines at its top level (a
function, a class, or an assignment; names it imports are the defining
module's to check), and each such class of the port has every public
method and class attribute the reference's class body defines (inherited
ones count). The package itself exports what the reference's does,
``__version__`` included.

A name with no counterpart fails the test unless it is in ``DEPARTURES``,
and every entry there names itself in MIGRATION.md's section on the port,
which says what stands in for it. An entry whose name the port has since
gained fails too, so the list stays true.
"""

import ast
import importlib
import os
import pkgutil
import re
from pathlib import Path

import siddhi_tpu
import siddhi_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

# reference name -> the MIGRATION.md entry that says what stands in for it
DEPARTURES = {
    "siddhi_tpu.parallel.mesh.force_host_devices": "force_host_devices",
    "siddhi_tpu.analysis.step_registry.INSTRUMENTED_STEP_BUILDERS":
        "INSTRUMENTED_STEP_BUILDERS",
    "siddhi_tpu.core.query.completion.QueryCompletion.meta_refs": "meta_refs",
    "siddhi_tpu.core.query.completion.FusedCompletion.meta_refs": "meta_refs",
    "siddhi_tpu.core.query.fused_fanout.FusedFanoutRuntime.lower_hlo_text":
        "lower_hlo_text",
    "siddhi_tpu.core.query.join_runtime.JoinSideProxy.process_timer":
        "JoinSideProxy.process_timer",
    "siddhi_tpu.core.query.runtime.QueryRuntime.flush_deferred": "flush_deferred",
    "siddhi_tpu.core.util.program_cache.log": "program_cache.log",
    "siddhi_tpu.core.util.program_cache.CacheEntry.matches": "CacheEntry.matches",
}
DEPARTURES.update({
    f"siddhi_tpu.ops.fused_agg.FusedSlidingAggStage.{a}": "FusedSlidingAggStage"
    for a in ("batch_mode", "needs_scheduler", "host_mode", "fused")})

# the public API this parity closed: never a departure
NEVER_DEPARTED = ("validate_siddhi_app", "create_sandbox_siddhi_app_runtime",
                  "persist_all", "restore_last_state", "get_queries", "query_names",
                  "is_stateful")


def _defined(stmts):
    """(name, node) of every function, class and assignment a body
    defines, inside ``if`` and ``try`` blocks too."""
    for s in stmts:
        if isinstance(s, (ast.If, ast.Try)):
            yield from _defined(s.body)
            yield from _defined(s.orelse)
            for h in getattr(s, "handlers", []):
                yield from _defined(h.body)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            yield s.name, s
        elif isinstance(s, ast.Assign):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    yield t.id, s
        elif isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name):
            yield s.target.id, s


def _has(cls, attr: str) -> bool:
    return (hasattr(cls, attr)
            or attr in getattr(cls, "__dataclass_fields__", {})
            or any(attr in getattr(c, "__annotations__", {})
                   for c in getattr(cls, "__mro__", ())))


def _missing():
    """Dotted reference names with no counterpart in the port."""
    out = []
    for name in siddhi_tpu.__all__:
        if not hasattr(siddhi_tpu_torch, name):
            out.append(f"siddhi_tpu.{name}")
    root = Path(siddhi_tpu.__file__).parent
    for info in pkgutil.walk_packages(siddhi_tpu.__path__, "siddhi_tpu."):
        parts = info.name.split(".")[1:]
        if any(p.startswith("_") for p in parts):
            continue
        path = root.joinpath(*parts)
        path = path.with_suffix(".py") if path.with_suffix(".py").exists() \
            else path / "__init__.py"
        try:
            port = importlib.import_module("siddhi_tpu_torch." + ".".join(parts))
        except ModuleNotFoundError:
            out.append(info.name)
            continue
        for name, node in _defined(ast.parse(path.read_text()).body):
            if name.startswith("_"):
                continue
            if not hasattr(port, name):
                out.append(f"{info.name}.{name}")
                continue
            if isinstance(node, ast.ClassDef):
                cls = getattr(port, name)
                out.extend(f"{info.name}.{name}.{attr}"
                           for attr, _n in _defined(node.body)
                           if not attr.startswith("_") and not _has(cls, attr))
    return out


def _migration_port_section() -> str:
    text = (ROOT / "MIGRATION.md").read_text()
    return text[text.index("## The PyTorch/CUDA port"):]


def test_every_public_name_has_a_counterpart():
    missing = _missing()
    assert sorted(set(missing) - set(DEPARTURES)) == []
    # an entry the port has since gained is no departure
    assert sorted(set(DEPARTURES) - set(missing)) == []


def test_every_departure_has_a_migration_line():
    section = _migration_port_section()
    for name, entry in DEPARTURES.items():
        assert f"`{entry}" in section, (name, entry)
        assert not any(name.endswith("." + n) for n in NEVER_DEPARTED), name


def test_package_version_and_exports():
    assert siddhi_tpu_torch.__version__ == siddhi_tpu.__version__
    assert set(siddhi_tpu.__all__) <= set(siddhi_tpu_torch.__all__)


def test_scan_reads_every_reference_module():
    """The walk sees every public module on disk (a tree it could not walk
    would make the parity test pass vacuously)."""
    mods = {m.name for m in pkgutil.walk_packages(siddhi_tpu.__path__, "siddhi_tpu.")}
    root = Path(siddhi_tpu.__file__).parent
    on_disk = set()
    for d, _s, files in os.walk(root):
        rel = Path(d).relative_to(root).parts
        if any(p.startswith("_") for p in rel):
            continue
        on_disk.update(".".join(("siddhi_tpu",) + rel + (f[:-3],)) for f in files
                       if re.fullmatch(r"[a-z]\w*\.py", f))
    assert on_disk and on_disk <= mods
