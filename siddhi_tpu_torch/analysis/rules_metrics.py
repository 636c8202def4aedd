"""R3 — metric-registration parity.

Counterpart of ``siddhi_tpu/analysis/rules_metrics.py``; the
declarations are read from ``siddhi_tpu_torch/observability/export.py``.

The regression class: per-granularity ``siddhi_aggregation_*``
gauges were registered on the sharded aggregation path but not its
unsharded twin, so /metrics silently lost families depending on a
config knob. The exposition layer (``observability/export.py``) is the
single place where telemetry names become ``siddhi_*`` Prometheus
families, and it now carries two machine-readable declarations:

- ``TELEMETRY_PREFIXES`` — every dotted telemetry-name family the tree
  may register (first segment, e.g. ``"pipeline"``). A ``.gauge()`` /
  ``.count()`` / ``.histogram()`` call whose name starts with an
  undeclared segment would fall through to the generic
  ``siddhi_gauge``/``siddhi_counter_total`` catch-all unnoticed — that
  is now a finding, as is a declared prefix with NO registration site
  left (dead declaration).
- ``PROCESS_LIFETIME_GAUGES`` — gauge-name templates that are
  intentionally never unregistered (process-lifetime probes). Every
  other gauge template must have a matching ``remove_gauge`` site
  somewhere in the tree, or a dissolved/shut-down owner pins a dead
  probe on /metrics forever.

Additionally, any literal ``siddhi_*`` family string OUTSIDE export.py
is flagged: families are declared centrally, not scattered.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from siddhi_tpu_torch.analysis.engine import Finding, LintContext, Rule

_FAMILY = re.compile(r"^siddhi_[a-z0-9_]+$")
# a telemetry name template: word-first dotted segments ('.py' or a
# leading-dot literal is NOT one — str.count("...") must never match)
_NAMEISH = re.compile(r"^[a-z][a-z0-9_]*[a-z0-9_.{}*]*\.[a-z0-9_.{}*]+$")
_REG_METHODS = ("gauge", "count", "histogram")
# `.count(` is a common str/list method: treat it as a telemetry
# registration only on a registry-looking receiver (the repo convention)
_COUNT_RECEIVERS = ("tel", "telemetry", "_tel", "registry", "sm",
                    "stats", "statistics_manager")


def _name_template(node: ast.AST) -> Optional[str]:
    """Literal dotted-name template of a registration arg, with every
    interpolated piece normalized to ``*`` ('junction.*.queue_depth')."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        return "".join(parts)
    return None


def _template_matches(template: str, pattern: str) -> bool:
    """fnmatch-lite where ``*`` in EITHER side matches any run."""
    rx = re.escape(pattern).replace(r"\*", ".*")
    tpl = re.escape(template).replace(r"\*", ".*")
    return bool(re.fullmatch(rx, template) or re.fullmatch(tpl, pattern))


class MetricParityRule(Rule):
    id = "R3"
    title = "metric-registration parity"

    @staticmethod
    def _countish(recv: ast.AST) -> bool:
        """Does a ``.count(...)`` receiver look like a telemetry
        registry (vs a str/list)?"""
        if isinstance(recv, ast.Name):
            return recv.id in _COUNT_RECEIVERS
        if isinstance(recv, ast.Attribute):
            return recv.attr in _COUNT_RECEIVERS
        if isinstance(recv, ast.Call):
            f = recv.func
            name = getattr(f, "attr", getattr(f, "id", ""))
            return name in ("global_registry",)
        return False

    def run(self, ctx: LintContext) -> List[Finding]:
        findings: List[Finding] = []
        gauges: Dict[str, tuple] = {}       # template -> (path, line)
        removed: Set[str] = set()
        seen_prefixes: Set[str] = set()
        declared = tuple(ctx.telemetry_prefixes)
        allow = tuple(ctx.unremoved_gauge_allow)
        export_suffix = ctx.export_path.rsplit("/", 1)[-1]

        for mod in ctx.modules:
            if mod.path.startswith("tests/"):
                continue
            is_export = mod.path.endswith(export_suffix)
            for node in ast.walk(mod.tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and _FAMILY.match(node.value)
                        and not node.value.startswith("siddhi_tpu")
                        and not is_export):
                    findings.append(Finding(
                        self.id, mod.path, node.lineno,
                        f"metric family '{node.value}' referenced "
                        f"outside observability/export.py — families "
                        f"are declared and rendered centrally there"))
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if (isinstance(fn, ast.Name) and fn.id == "stat_count"
                        and len(node.args) >= 2):
                    # resilience counters ride the StatisticsManager via
                    # the stat_count helper — same naming discipline
                    tpl = _name_template(node.args[1])
                    if tpl and "." in tpl and _NAMEISH.match(tpl):
                        prefix = tpl.split(".", 1)[0]
                        seen_prefixes.add(prefix)
                        if declared and prefix not in declared:
                            findings.append(Finding(
                                self.id, mod.path, node.lineno,
                                f"counter '{tpl}' starts with "
                                f"undeclared prefix '{prefix}' — add "
                                f"it to TELEMETRY_PREFIXES in "
                                f"export.py"))
                    continue
                if not isinstance(fn, ast.Attribute) or not node.args:
                    continue
                if fn.attr in _REG_METHODS or fn.attr == "remove_gauge":
                    if fn.attr == "count" and not self._countish(fn.value):
                        continue    # str.count / list.count, not telemetry
                    tpl = _name_template(node.args[0])
                    if (tpl is None or "." not in tpl
                            or not _NAMEISH.match(tpl)):
                        continue    # not a telemetry name (str.count etc.)
                    if fn.attr == "remove_gauge":
                        removed.add(tpl)
                        continue
                    prefix = tpl.split(".", 1)[0]
                    if prefix == "*":
                        continue    # fully dynamic — uncheckable
                    seen_prefixes.add(prefix)
                    if declared and prefix not in declared:
                        findings.append(Finding(
                            self.id, mod.path, node.lineno,
                            f"telemetry name '{tpl}' starts with "
                            f"undeclared prefix '{prefix}' — add it to "
                            f"TELEMETRY_PREFIXES in export.py WITH a "
                            f"family mapping, or it renders as a "
                            f"generic catch-all"))
                    if fn.attr == "gauge":
                        gauges.setdefault(tpl, (mod.path, node.lineno))

        # dead declarations: a prefix with no registration site left
        exp = ctx.module(ctx.export_path) or ctx.module("export.py")
        exp_path = exp.path if exp is not None else "export.py"
        for prefix in declared:
            if prefix not in seen_prefixes:
                findings.append(Finding(
                    self.id, exp_path, 1,
                    f"TELEMETRY_PREFIXES declares '{prefix}' but no "
                    f"gauge/count/histogram registration uses it — "
                    f"remove the dead declaration"))

        # register/unregister pairing
        for tpl, (path, line) in sorted(gauges.items()):
            if any(_template_matches(tpl, r) for r in removed):
                continue
            if any(_template_matches(tpl, a) for a in allow):
                continue
            findings.append(Finding(
                self.id, path, line,
                f"gauge '{tpl}' is registered but never removed and is "
                f"not in PROCESS_LIFETIME_GAUGES (export.py) — a "
                f"dissolved owner would pin a dead probe on /metrics"))
        return findings
