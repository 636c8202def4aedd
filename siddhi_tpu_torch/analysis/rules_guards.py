"""R8 — guarded-by lock coverage.

Counterpart of ``siddhi_tpu/analysis/rules_guards.py``, over the
``GUARDED_BY`` maps of the port's threaded classes.

R4 checks the ORDER locks are taken in; nothing checked which fields a
lock actually protects — that contract lived in prose ("callers hold
the pump lock", "caller holds the shard lock") and every post-review
race fix in CHANGES.md is a field that escaped it. A threaded class now
declares the contract as data:

    class CompletionPump:
        GUARDED_BY = {"_pending": "pump"}

(ranks from ``analysis/lockorder.py``; the runtime half is
``analysis/guards.py`` — descriptor-asserted access under
``SIDDHI_TPU_SANITIZE=1``). This rule learns every declaration
tree-wide and flags, in the declaring class:

- any ``self._field`` read/write outside a ``with`` on a lock of the
  declared rank (``__init__`` is exempt — construction precedes
  sharing; methods named ``*_locked`` are exempt — the suffix is the
  repo's caller-holds-the-lock idiom, and the runtime descriptors still
  verify them);
- a ``GUARDED_BY`` rank not declared in ``lockorder.RANKS``;
- a declared field with ZERO locked accesses anywhere in the class — a
  stale declaration guards nothing;
- and, bidirectionally: a class that spawns threads, shares an
  obviously-mutable field (dict/list/set/deque built in ``__init__``,
  written in other methods) and declares NO ``GUARDED_BY`` at all —
  undeclared shared state in threaded code is the original sin this
  rule exists to retire.

Lock-rank resolution is R4's: ``self.<attr> = make_lock("<rank>")``
learned per class, ``<var>._lock`` through ``VARIABLE_RANKS``,
``_barrier`` attributes, plus ``threading.Condition(self.<lock>)``
aliases (a ``with self._cv:`` holds the wrapped lock's rank).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from siddhi_tpu_torch.analysis import lockorder
from siddhi_tpu_torch.analysis.engine import Finding, LintContext, Rule

# mutating calls that count as writes for the undeclared-shared-state
# check (ast attribute name on the field)
_MUTATORS = frozenset({
    "append", "appendleft", "add", "update", "setdefault", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "extend",
    "insert",
})

_MUTABLE_BUILDERS = frozenset({
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter",
})


def _dict_literal(node: ast.AST) -> Optional[Dict[str, str]]:
    """A ``{"field": "rank", ...}`` literal, or None."""
    if not isinstance(node, ast.Dict):
        return None
    out: Dict[str, str] = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Constant)
                and isinstance(v.value, str)):
            return None
        out[k.value] = v.value
    return out


def _is_mutable_ctor(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                         ast.ListComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        return name in _MUTABLE_BUILDERS
    return False


class _ClassFacts:
    """Everything R8 learns about one class definition."""

    def __init__(self, node: ast.ClassDef, mod_path: str):
        self.node = node
        self.mod_path = mod_path
        self.guarded: Dict[str, str] = {}
        self.guarded_line: int = node.lineno
        self.lock_ranks: Dict[str, str] = {}    # self.<attr> -> rank
        self.spawns_threads = False
        self._learn()

    def _learn(self) -> None:
        for sub in ast.walk(self.node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                tgt = sub.targets[0]
                if isinstance(tgt, ast.Name) and tgt.id == "GUARDED_BY":
                    declared = _dict_literal(sub.value)
                    if declared is not None:
                        self.guarded = declared
                        self.guarded_line = sub.lineno
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and isinstance(sub.value, ast.Call)
                        and isinstance(sub.value.func, ast.Name)
                        and sub.value.func.id == "make_lock"
                        and sub.value.args
                        and isinstance(sub.value.args[0], ast.Constant)):
                    self.lock_ranks[tgt.attr] = sub.value.args[0].value
            if isinstance(sub, ast.Call):
                fn = sub.func
                name = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None)
                if name == "Thread":
                    self.spawns_threads = True
        # second pass: Condition(self.<lock>) aliases inherit the rank
        for sub in ast.walk(self.node):
            if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                continue
            tgt = sub.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and isinstance(sub.value, ast.Call)):
                continue
            fn = sub.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if name != "Condition" or not sub.value.args:
                continue
            wrapped = sub.value.args[0]
            if (isinstance(wrapped, ast.Attribute)
                    and isinstance(wrapped.value, ast.Name)
                    and wrapped.value.id == "self"
                    and wrapped.attr in self.lock_ranks):
                self.lock_ranks[tgt.attr] = self.lock_ranks[wrapped.attr]


class GuardedByRule(Rule):
    id = "R8"
    title = "guarded-by lock coverage"

    def run(self, ctx: LintContext) -> List[Finding]:
        findings: List[Finding] = []
        for mod in ctx.modules:
            if mod.path.startswith("tests/"):
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    self._check_class(mod, _ClassFacts(node, mod.path),
                                      findings)
        return findings

    # ------------------------------------------------------------ per class

    def _check_class(self, mod, facts: _ClassFacts,
                     findings: List[Finding]) -> None:
        cls = facts.node
        if not facts.guarded:
            self._check_undeclared(mod, facts, findings)
            return
        for fname, rank in facts.guarded.items():
            if rank not in lockorder.RANKS:
                findings.append(Finding(
                    self.id, mod.path, facts.guarded_line,
                    f"{cls.name}.GUARDED_BY['{fname}'] names undeclared "
                    f"lock rank '{rank}' — add it to "
                    f"analysis/lockorder.py RANKS"))
        locked_uses: Dict[str, int] = {f: 0 for f in facts.guarded}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_method(mod, facts, item, findings, locked_uses)
        for fname, n in locked_uses.items():
            if facts.guarded.get(fname) not in lockorder.RANKS:
                continue    # already reported as an undeclared rank
            if n == 0:
                findings.append(Finding(
                    self.id, mod.path, facts.guarded_line,
                    f"{cls.name}.GUARDED_BY declares '{fname}' but the "
                    f"class has no locked access to it — a stale "
                    f"declaration guards nothing (drop it or use the "
                    f"field under its lock)"))

    # ------------------------------------------------------- method scan

    def _scan_method(self, mod, facts: _ClassFacts, func, findings,
                     locked_uses: Dict[str, int]) -> None:
        if func.name == "__init__":
            # construction precedes sharing (the runtime descriptor
            # exempts it identically) — but still count nothing
            return
        if func.name.endswith("_locked"):
            base_held: Set[str] = set(facts.guarded.values())
        else:
            base_held = set()

        def rank_of(expr: ast.AST) -> Optional[str]:
            if isinstance(expr, ast.Attribute):
                if expr.attr in lockorder.BARRIER_ATTRS:
                    return "barrier"
                if isinstance(expr.value, ast.Name):
                    base = expr.value.id
                    if base == "self":
                        return facts.lock_ranks.get(expr.attr)
                    if expr.attr == "_lock":
                        return lockorder.VARIABLE_RANKS.get(base)
            return None

        def check_expr(expr: ast.AST, held: Set[str]) -> None:
            for sub in ast.walk(expr):
                if (isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"
                        and sub.attr in facts.guarded):
                    rank = facts.guarded[sub.attr]
                    if rank not in lockorder.RANKS:
                        continue
                    if rank in held:
                        locked_uses[sub.attr] += 1
                    else:
                        findings.append(Finding(
                            self.id, mod.path, sub.lineno,
                            f"access to {facts.node.name}.{sub.attr} "
                            f"outside a '{rank}'-ranked lock — "
                            f"GUARDED_BY declares it guarded; wrap the "
                            f"access in `with` on the lock (or amend "
                            f"the contract)"))

        def walk(body, held: Set[str]) -> None:
            for st in body:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # nested defs run later, on unknown threads
                    self._scan_method(mod, facts, st, findings,
                                      locked_uses)
                    continue
                if isinstance(st, ast.With):
                    acquired = set(held)
                    for item in st.items:
                        r = rank_of(item.context_expr)
                        if r is not None:
                            acquired.add(r)
                        check_expr(item.context_expr, held)
                    walk(st.body, acquired)
                    continue
                # check this statement's own expressions, then descend
                # into compound bodies with the same held set
                for sub in ast.iter_child_nodes(st):
                    if isinstance(sub, ast.expr):
                        check_expr(sub, held)
                    elif isinstance(sub, ast.ExceptHandler):
                        walk(sub.body, held)
                    elif isinstance(sub, ast.stmt):
                        walk([sub], held)
        walk(func.body, set(base_held))

    # ------------------------------------------------ undeclared classes

    def _check_undeclared(self, mod, facts: _ClassFacts,
                          findings: List[Finding]) -> None:
        """Bidirectional half: a thread-spawning class sharing mutable
        state with no GUARDED_BY at all."""
        if not facts.spawns_threads:
            return
        cls = facts.node
        built: Dict[str, int] = {}
        for item in cls.body:
            if (isinstance(item, ast.FunctionDef)
                    and item.name == "__init__"):
                for sub in ast.walk(item):
                    if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                        tgt, val = sub.targets[0], sub.value
                    elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                        tgt, val = sub.target, sub.value
                    else:
                        continue
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                            and _is_mutable_ctor(val)):
                        built[tgt.attr] = sub.lineno
        if not built:
            return
        written: Set[str] = set()
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if item.name == "__init__":
                continue
            for sub in ast.walk(item):
                attr = None
                if (isinstance(sub, ast.Attribute)
                        and isinstance(sub.ctx, (ast.Store, ast.Del))
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"):
                    attr = sub.attr
                elif (isinstance(sub, ast.Subscript)
                        and isinstance(sub.ctx, (ast.Store, ast.Del))
                        and isinstance(sub.value, ast.Attribute)
                        and isinstance(sub.value.value, ast.Name)
                        and sub.value.value.id == "self"):
                    attr = sub.value.attr
                elif (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in _MUTATORS
                        and isinstance(sub.func.value, ast.Attribute)
                        and isinstance(sub.func.value.value, ast.Name)
                        and sub.func.value.value.id == "self"):
                    attr = sub.func.value.attr
                if attr in built:
                    written.add(attr)
        if written:
            fields = ", ".join(sorted(written))
            findings.append(Finding(
                self.id, mod.path, cls.lineno,
                f"thread-spawning class {cls.name} mutates shared "
                f"field(s) {fields} with no GUARDED_BY declaration — "
                f"declare the guarding rank(s) (analysis/guards.py) or "
                f"suppress with a reviewed justification"))
