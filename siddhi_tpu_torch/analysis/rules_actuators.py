"""R7 — actuator parity (autopilot control surface).

Counterpart of ``siddhi_tpu/analysis/rules_actuators.py``, over the
port's ``siddhi_tpu_torch/autopilot/``.

The autopilot's control surface is a contract between three places: the
typed knob registry (``core/util/knobs.py`` ``Knob(...)``
declarations), the actuator table (``autopilot/actuators.py``
``Actuator(...)`` constructions), and the policy rules that reference
actuators by name (``autopilot/policy.py``
``PolicyRule(...)`` constructions). An actuator driving an undeclared
knob would bypass the R2 discipline (one sanctioned ``read_knob`` site,
parseable config surface); a policy rule naming an actuator nobody
declares is an actuation path that silently never fires; an actuator no
rule references is dead control surface the operator reads about in
``GET /autopilot`` but the policy can never exercise. All three are
findings, bidirectional like R3 (metric prefixes) and R6 (instrument
slots):

- an ``Actuator(...)`` whose ``knob=`` names no ``Knob(...)`` key in
  ``core/util/knobs.py``;
- a ``PolicyRule(...)`` whose ``actuator=`` matches no declared
  ``Actuator(...)`` name (undeclared actuation path);
- an ``Actuator(...)`` referenced by no ``PolicyRule(...)`` (dead
  declaration).

The rule is silent on trees with neither construction (graftlint must
run on foreign trees), and skips ``tests/`` like R6 — fixtures and unit
tests construct throwaway actuators on purpose.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from siddhi_tpu_torch.analysis.engine import Finding, LintContext, Rule

KNOBS_PATH_SUFFIX = "core/util/knobs.py"


def _literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _call_named(node: ast.AST, name: str) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    return getattr(fn, "attr", getattr(fn, "id", None)) == name


class ActuatorParityRule(Rule):
    id = "R7"
    title = "actuator parity"

    @staticmethod
    def _knob_keys(tree: ast.AST) -> Set[str]:
        """First-arg literals of every ``Knob(...)`` construction — the
        typed knob registry's declared key set."""
        keys: Set[str] = set()
        for node in ast.walk(tree):
            if _call_named(node, "Knob") and node.args:
                key = _literal_str(node.args[0])
                if key is not None:
                    keys.add(key)
        return keys

    @staticmethod
    def _actuator_calls(tree: ast.AST) -> List[
            Tuple[int, Optional[str], Optional[str]]]:
        """(line, name, knob) of every ``Actuator(...)`` construction
        with resolvable literal kwargs (positional first arg = name)."""
        out = []
        for node in ast.walk(tree):
            if not _call_named(node, "Actuator"):
                continue
            name = _literal_str(node.args[0]) if node.args else None
            knob = None
            for kw in node.keywords:
                if kw.arg == "name" and name is None:
                    name = _literal_str(kw.value)
                elif kw.arg == "knob":
                    knob = _literal_str(kw.value)
            out.append((node.lineno, name, knob))
        return out

    @staticmethod
    def _rule_calls(tree: ast.AST) -> List[Tuple[int, Optional[str]]]:
        """(line, actuator) of every ``PolicyRule(...)`` construction
        (second positional arg = actuator)."""
        out = []
        for node in ast.walk(tree):
            if not _call_named(node, "PolicyRule"):
                continue
            actuator = (_literal_str(node.args[1])
                        if len(node.args) >= 2 else None)
            for kw in node.keywords:
                if kw.arg == "actuator" and actuator is None:
                    actuator = _literal_str(kw.value)
            out.append((node.lineno, actuator))
        return out

    def run(self, ctx: LintContext) -> List[Finding]:
        findings: List[Finding] = []
        knob_keys: Set[str] = set()
        actuators: List[Tuple[str, int, Optional[str], Optional[str]]] = []
        rules: List[Tuple[str, int, Optional[str]]] = []
        for mod in ctx.modules:
            if mod.path.startswith("tests/"):
                continue
            if mod.path.endswith(KNOBS_PATH_SUFFIX):
                knob_keys |= self._knob_keys(mod.tree)
            for line, name, knob in self._actuator_calls(mod.tree):
                actuators.append((mod.path, line, name, knob))
            for line, actuator in self._rule_calls(mod.tree):
                rules.append((mod.path, line, actuator))
        if not actuators and not rules:
            return findings    # tree without an autopilot plane
        declared = {name for _p, _l, name, _k in actuators
                    if name is not None}
        referenced = {a for _p, _l, a in rules if a is not None}
        for path, line, name, knob in actuators:
            if knob is not None and knob not in knob_keys:
                findings.append(Finding(
                    self.id, path, line,
                    f"actuator '{name}' drives knob '{knob}' which is "
                    f"not a Knob(...) declaration in "
                    f"{KNOBS_PATH_SUFFIX} — actuation must ride the "
                    f"typed knob registry"))
            if name is not None and name not in referenced:
                findings.append(Finding(
                    self.id, path, line,
                    f"actuator '{name}' is referenced by no "
                    f"PolicyRule(...) — dead control surface the "
                    f"policy can never exercise"))
        for path, line, actuator in rules:
            if actuator is not None and actuator not in declared:
                findings.append(Finding(
                    self.id, path, line,
                    f"policy rule references actuator '{actuator}' "
                    f"which no Actuator(...) construction declares — "
                    f"an actuation path that silently never fires"))
        return findings
