"""R4 — lock-order discipline.

Counterpart of ``siddhi_tpu/analysis/rules_locks.py``; ranks, edges and
recognizers come from the port's ``analysis/lockorder.py``.

The hot-path acquisition orders (owner -> pump, shard -> WAL-record,
everything under the app barrier) used to be enforced by prose in
docstrings; ``analysis/lockorder.py`` now declares them as a partial
order, the runtime shim (``analysis/locks.py``) asserts them under
``SIDDHI_TPU_SANITIZE=1``, and this rule flags LEXICALLY nested
acquisitions that invert them at review time.

Rank resolution (static side):

1. a first pass learns ``(class, attr) -> rank`` from every
   ``self.<attr> = make_lock("<rank>")`` assignment in the tree;
2. ``with self.<attr>:`` resolves through the enclosing class;
3. ``with <var>._lock:`` (or a single-assignment alias of it, incl.
   ``getattr(<var>, "_lock", ...)``) resolves through
   ``lockorder.VARIABLE_RANKS`` on the variable name — ``owner._lock``
   is an owner lock wherever it appears;
4. ``self._barrier`` / ``<var>._barrier`` is always the barrier.

Unranked locks are invisible to the rule. Acquiring rank B inside rank
A is a finding when the declared closure says B must precede A.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from siddhi_tpu_torch.analysis import lockorder
from siddhi_tpu_torch.analysis.engine import Finding, LintContext, Rule


def _rank_of_expr(node: ast.AST, class_ranks: Dict[Tuple[str, str], str],
                  cls_name: Optional[str],
                  aliases: Dict[str, str]) -> Optional[str]:
    """Resolve a with-item expression to a declared rank, or None."""
    if isinstance(node, ast.Name):
        return aliases.get(node.id)
    if not isinstance(node, ast.Attribute):
        return None
    if node.attr in lockorder.BARRIER_ATTRS:
        return "barrier"
    if isinstance(node.value, ast.Name):
        base = node.value.id
        if base == "self" and cls_name is not None:
            rank = class_ranks.get((cls_name, node.attr))
            if rank is not None:
                return rank
        if node.attr == "_lock":
            return lockorder.VARIABLE_RANKS.get(base)
    return None


def _alias_rank(value: ast.AST, class_ranks, cls_name, aliases):
    """Rank of an assignment's RHS: a direct lock expr or
    ``getattr(<var>, "_lock", ...)``."""
    rank = _rank_of_expr(value, class_ranks, cls_name, aliases)
    if rank is not None:
        return rank
    if (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id == "getattr" and len(value.args) >= 2):
        tgt, attr = value.args[0], value.args[1]
        if (isinstance(attr, ast.Constant) and attr.value == "_lock"
                and isinstance(tgt, ast.Name)):
            return lockorder.VARIABLE_RANKS.get(tgt.id)
    return None


class LockOrderRule(Rule):
    id = "R4"
    title = "lock-order discipline"

    def run(self, ctx: LintContext) -> List[Finding]:
        class_ranks: Dict[Tuple[str, str], str] = {}
        for mod in ctx.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Assign)
                            and isinstance(sub.value, ast.Call)
                            and isinstance(sub.value.func, ast.Name)
                            and sub.value.func.id == "make_lock"
                            and sub.value.args
                            and isinstance(sub.value.args[0], ast.Constant)):
                        for tgt in sub.targets:
                            if (isinstance(tgt, ast.Attribute)
                                    and isinstance(tgt.value, ast.Name)
                                    and tgt.value.id == "self"):
                                class_ranks[(node.name, tgt.attr)] = \
                                    sub.value.args[0].value

        findings: List[Finding] = []
        for mod in ctx.modules:
            if mod.path.startswith("tests/"):
                continue
            self._scan(mod, mod.tree, None, class_ranks, findings)
        return findings

    def _scan(self, mod, tree, cls_name, class_ranks, findings) -> None:
        for node in ast.iter_child_nodes(tree):
            if isinstance(node, ast.ClassDef):
                self._scan(mod, node, node.name, class_ranks, findings)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_func(mod, node, cls_name, class_ranks, findings)
            else:
                self._scan(mod, node, cls_name, class_ranks, findings)

    def _scan_func(self, mod, func, cls_name, class_ranks, findings):
        aliases: Dict[str, str] = dict(lockorder.VARIABLE_RANKS)

        def walk(body, held: List[Tuple[str, int]]):
            for st in body:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # nested defs run later, under unknown held-locks
                    self._scan_func(mod, st, cls_name, class_ranks,
                                    findings)
                    continue
                if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name):
                    rank = _alias_rank(st.value, class_ranks, cls_name,
                                       aliases)
                    if rank is not None:
                        aliases[st.targets[0].id] = rank
                if isinstance(st, ast.With):
                    acquired = []
                    for item in st.items:
                        rank = _rank_of_expr(item.context_expr,
                                             class_ranks, cls_name,
                                             aliases)
                        if rank is None:
                            continue
                        for held_rank, held_line in held:
                            if lockorder.inversion(held_rank, rank):
                                findings.append(Finding(
                                    self.id, mod.path, st.lineno,
                                    f"acquiring '{rank}' lock while "
                                    f"holding '{held_rank}' (line "
                                    f"{held_line}) inverts the declared "
                                    f"order '{rank}' -> '{held_rank}' "
                                    f"(analysis/lockorder.py)"))
                        acquired.append((rank, st.lineno))
                    walk(st.body, held + acquired)
                    continue
                # descend into compound-statement bodies (if/for/while/
                # try/except) statement-by-statement, keeping the held
                # stack — alias assignments inside them are learned too
                for sub in ast.iter_child_nodes(st):
                    if isinstance(sub, ast.ExceptHandler):
                        walk(sub.body, held)
                    elif isinstance(sub, ast.stmt):
                        walk([sub], held)
        walk(func.body, [])
