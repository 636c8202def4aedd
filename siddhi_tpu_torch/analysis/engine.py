"""graftlint engine: rule registry, module loader, suppressions.

Counterpart of ``siddhi_tpu/analysis/engine.py``: the same classes, the
same suppression grammar, the same declarations, read from the port's
own ``observability/export.py``. The command line is ``python -m
siddhi_tpu_torch.analysis`` (``analysis/__main__.py``); the per-rule
modules are ``rules_*.py``. Design:

- **ModuleInfo** — parsed source + per-line suppression table. A line
  containing ``# graftlint: disable=R1`` (comma-separated ids, or
  ``all``) suppresses findings on that line; ``# graftlint:
  disable-file=R3`` anywhere in the file suppresses the whole file for
  that rule. Suppressions are deliberate, reviewable escape hatches —
  prefer fixing the finding, and give the reason on the line.
- **Rule** — ``id``/``title`` plus ``run(ctx)`` over ALL modules (rules
  that learn facts in one file and check another — lock ranks, metric
  declarations — need the whole tree).
- **LintContext** — the loaded modules plus declarations parsed from
  ``observability/export.py`` and ``analysis/lockorder.py``; tests
  override it to point rules at fixture trees.

The engine and every rule import the standard library only, never
torch: the linter runs anywhere, in milliseconds, with no device in
sight (that being rather the point of R1).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

_SUPPRESS = re.compile(r"#\s*graftlint:\s*disable(?P<scope>-file)?="
                       r"(?P<ids>[A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


@dataclass
class ModuleInfo:
    path: str           # repo-relative, forward slashes
    src: str
    tree: ast.AST
    line_suppress: Dict[int, set] = field(default_factory=dict)
    file_suppress: set = field(default_factory=set)

    @classmethod
    def load(cls, path: str, rel: str) -> "ModuleInfo":
        with open(path, encoding="utf-8") as f:
            src = f.read()
        mod = cls(path=rel.replace(os.sep, "/"), src=src,
                  tree=ast.parse(src, filename=rel))
        for lineno, line in enumerate(src.splitlines(), 1):
            m = _SUPPRESS.search(line)
            if not m:
                continue
            ids = {s.strip() for s in m.group("ids").split(",") if s.strip()}
            if m.group("scope"):
                mod.file_suppress |= ids
            else:
                mod.line_suppress.setdefault(lineno, set()).update(ids)
        return mod

    def suppressed(self, rule_id: str, line: int) -> bool:
        if {"all", rule_id} & self.file_suppress:
            return True
        ids = self.line_suppress.get(line)
        return bool(ids and {"all", rule_id} & ids)


class Rule:
    id: str = "R?"
    title: str = ""

    def run(self, ctx: "LintContext") -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


@dataclass
class LintContext:
    modules: List[ModuleInfo]
    # R3/R6 declarations parsed out of observability/export.py
    # (overridable by fixture tests)
    telemetry_prefixes: Sequence[str] = ()
    unremoved_gauge_allow: Sequence[str] = ()
    device_slots: Sequence[str] = ()
    device_check_slots: Sequence[str] = ()
    export_path: str = "siddhi_tpu_torch/observability/export.py"

    def module(self, suffix: str) -> Optional[ModuleInfo]:
        for m in self.modules:
            if m.path.endswith(suffix):
                return m
        return None


def iter_py_files(roots: Sequence[str], base: str) -> List[str]:
    out = []
    for root in roots:
        full = os.path.join(base, root)
        if os.path.isfile(full):
            out.append(full)
            continue
        for d, dirs, files in os.walk(full):
            dirs[:] = [x for x in dirs if x != "__pycache__"]
            out.extend(os.path.join(d, f) for f in sorted(files)
                       if f.endswith(".py"))
    return sorted(set(out))


def load_modules(roots: Sequence[str], base: str) -> List[ModuleInfo]:
    mods = []
    for path in iter_py_files(roots, base):
        rel = os.path.relpath(path, base)
        mods.append(ModuleInfo.load(path, rel))
    return mods


def _parse_export_declarations(ctx: LintContext) -> None:
    """Pull the R3 declaration tuples out of export.py's AST (the
    declarations live WITH the exposition code so they cannot drift
    from it in a separate config file)."""
    exp = ctx.module(ctx.export_path) or ctx.module("export.py")
    if exp is None:
        return
    for node in ast.walk(exp.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        if tgt.id in ("TELEMETRY_PREFIXES", "PROCESS_LIFETIME_GAUGES",
                      "DEVICE_SLOTS", "DEVICE_CHECK_SLOTS"):
            try:
                val = tuple(ast.literal_eval(node.value))
            except (ValueError, SyntaxError):
                continue
            if tgt.id == "TELEMETRY_PREFIXES":
                ctx.telemetry_prefixes = val
            elif tgt.id == "PROCESS_LIFETIME_GAUGES":
                ctx.unremoved_gauge_allow = val
            elif tgt.id == "DEVICE_SLOTS":
                ctx.device_slots = val
            else:
                ctx.device_check_slots = val


def default_rules() -> List[Rule]:
    from siddhi_tpu_torch.analysis.rules_actuators import ActuatorParityRule
    from siddhi_tpu_torch.analysis.rules_backend import BackendInitRule
    from siddhi_tpu_torch.analysis.rules_config import ConfigKnobRule
    from siddhi_tpu_torch.analysis.rules_guards import GuardedByRule
    from siddhi_tpu_torch.analysis.rules_hotpath import HostPullRule
    from siddhi_tpu_torch.analysis.rules_instruments import InstrumentParityRule
    from siddhi_tpu_torch.analysis.rules_locks import LockOrderRule
    from siddhi_tpu_torch.analysis.rules_metrics import MetricParityRule

    return [BackendInitRule(), ConfigKnobRule(), MetricParityRule(),
            LockOrderRule(), HostPullRule(), InstrumentParityRule(),
            ActuatorParityRule(), GuardedByRule()]


def run_lint(modules: List[ModuleInfo],
             rules: Optional[Sequence[Rule]] = None,
             ctx: Optional[LintContext] = None) -> List[Finding]:
    if ctx is None:
        ctx = LintContext(modules=modules)
    else:
        ctx.modules = modules
    if not ctx.telemetry_prefixes:
        _parse_export_declarations(ctx)
    findings: List[Finding] = []
    by_path = {m.path: m for m in modules}
    for rule in (rules if rules is not None else default_rules()):
        for f in rule.run(ctx):
            mod = by_path.get(f.path)
            if mod is not None and mod.suppressed(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
