"""R6 — device-instrument parity.

Counterpart of ``siddhi_tpu/analysis/rules_instruments.py``; the
declarations are the port's ``DEVICE_SLOTS``/``DEVICE_CHECK_SLOTS``.

The device telemetry plane (``observability/instruments.py``) is a
contract between three places: a step builder's ``instrument_slots()``
spec (``Slot(...)`` constructions), the drain consumers
(``_consume_check_slot`` implementations for structural slots, the
``device.<query>.<slot>`` exposition for data slots), and the
``DEVICE_SLOTS`` / ``DEVICE_CHECK_SLOTS`` declarations in
``observability/export.py`` that the exposition regexes are built from.
A slot computed on device but never declared would silently render as a
generic catch-all (or not at all); a check slot without a consumer
would ship lanes nobody verifies; a declared slot nobody computes is a
dead declaration. All of those are findings:

- a data ``Slot("name")`` whose name template matches no
  ``DEVICE_SLOTS`` entry;
- a ``Slot("name", kind="check")`` whose name appears in no
  ``_consume_check_slot`` implementation;
- a ``DEVICE_SLOTS`` entry no ``Slot(...)`` construction produces;
- a ``DEVICE_CHECK_SLOTS`` entry no ``Slot(..., kind="check")``
  construction produces.

F-string slot names normalize interpolations to ``*``
(``Slot(f"fill.{side}")`` matches ``fill.left``/``fill.right``), same
as R3's template discipline.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from siddhi_tpu_torch.analysis.engine import Finding, LintContext, Rule


def _literal_template(node: ast.AST) -> Optional[str]:
    """Literal (or f-string, interpolations -> ``*``) string template."""
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


def _template_matches(template: str, name: str) -> bool:
    rx = re.escape(template).replace(r"\*", ".*")
    return bool(re.fullmatch(rx, name))


class InstrumentParityRule(Rule):
    id = "R6"
    title = "device-instrument parity"

    @staticmethod
    def _slot_calls(tree: ast.AST) -> List[Tuple[ast.Call, str, str]]:
        """(call, name_template, kind) of every ``Slot(...)``
        construction with a resolvable literal name."""
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            fname = getattr(fn, "attr", getattr(fn, "id", None))
            if fname != "Slot":
                continue
            name_node = node.args[0] if node.args else None
            kind = "gauge"
            for kw in node.keywords:
                if kw.arg == "name" and name_node is None:
                    name_node = kw.value
                if (kw.arg == "kind" and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, str)):
                    kind = kw.value.value
            tpl = _literal_template(name_node) if name_node is not None \
                else None
            if tpl is not None:
                out.append((node, tpl, kind))
        return out

    @staticmethod
    def _check_consumer_literals(tree: ast.AST) -> List[str]:
        """String constants inside ``_consume_check_slot``
        implementations — the names a drain actually handles."""
        lits = []
        for node in ast.walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name == "_consume_check_slot"):
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Constant)
                            and isinstance(sub.value, str)):
                        lits.append(sub.value)
        return lits

    def run(self, ctx: LintContext) -> List[Finding]:
        findings: List[Finding] = []
        declared = tuple(getattr(ctx, "device_slots", ()) or ())
        declared_checks = tuple(
            getattr(ctx, "device_check_slots", ()) or ())
        slot_calls: List[Tuple[str, int, str, str]] = []
        consumers: List[str] = []
        for mod in ctx.modules:
            if mod.path.startswith("tests/"):
                continue
            consumers.extend(self._check_consumer_literals(mod.tree))
            for call, tpl, kind in self._slot_calls(mod.tree):
                slot_calls.append((mod.path, call.lineno, tpl, kind))
        if not slot_calls and not declared:
            return findings    # tree without the instrument plane
        for path, line, tpl, kind in slot_calls:
            if kind == "check":
                if declared_checks and not any(
                        _template_matches(tpl, c) or tpl == c
                        for c in declared_checks):
                    findings.append(Finding(
                        self.id, path, line,
                        f"check slot '{tpl}' is not declared in "
                        f"DEVICE_CHECK_SLOTS (observability/export.py)"))
                if not any(_template_matches(tpl, c) or c == tpl
                           for c in consumers):
                    findings.append(Finding(
                        self.id, path, line,
                        f"check slot '{tpl}' has no drain consumer — no "
                        f"_consume_check_slot implementation handles it"))
            else:
                if declared and not any(
                        _template_matches(tpl, d) for d in declared):
                    findings.append(Finding(
                        self.id, path, line,
                        f"instrument slot '{tpl}' matches no DEVICE_SLOTS "
                        f"entry in observability/export.py — its "
                        f"device.* telemetry would render as an "
                        f"undeclared catch-all"))
        # dead declarations: a declared slot nobody computes
        exp = ctx.module(ctx.export_path) or ctx.module("export.py")
        exp_path = exp.path if exp is not None else "export.py"
        data_tpls = [t for _p, _l, t, k in slot_calls if k != "check"]
        check_tpls = [t for _p, _l, t, k in slot_calls if k == "check"]
        for d in declared:
            if not any(_template_matches(t, d) for t in data_tpls):
                findings.append(Finding(
                    self.id, exp_path, 1,
                    f"DEVICE_SLOTS declares '{d}' but no Slot(...) "
                    f"construction produces it — remove the dead "
                    f"declaration"))
        for c in declared_checks:
            if not any(_template_matches(t, c) or t == c
                       for t in check_tpls):
                findings.append(Finding(
                    self.id, exp_path, 1,
                    f"DEVICE_CHECK_SLOTS declares '{c}' but no "
                    f"Slot(..., kind='check') construction produces it"))
        return findings
