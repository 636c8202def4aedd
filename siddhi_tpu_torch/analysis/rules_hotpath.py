"""R5 — no host pull in code a step captures.

The torch counterpart of ``siddhi_tpu/analysis/rules_hotpath.py``. On
the card a capturable step runs as one CUDA-graph replay a batch
(``core/query/step_graph.py``): a ``float()``/``int()``/``bool()``/
``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``np.asarray()`` or a
``torch.cuda.synchronize()`` inside it either breaks the capture or, run
eagerly, costs a synchronous device-to-host round trip a batch, the one
the completion pump exists to batch into one meta pull.

Step bodies, the functions scanned:

- functions handed, by name, to ``instrument_jit(...)`` /
  ``InstrumentedJit(...)`` or to a step graph's ``run``/``_capture``
  anywhere in the same module (``observability/telemetry.py``
  ``instrument_jit`` wraps every step the port builds);
- nested defs named like a step kernel (``step``, ``fn``, ``kernel``,
  ``fused``, ``sharded``, ``one_dev``) inside a builder, in
  ``core/query/``, ``core/join/``, ``parallel/`` and ``ops/``.

Sanctioned, exactly what the runtime pull guard
(``analysis/sanitize.py``) sanctions:

- code inside ``with allowed_pull():`` (``sanitize.allowed_pull``);
- the methods of a stage that declares ``capturable = False`` in its
  class body: such a step is never captured and runs eagerly. Of the
  host reads ROADMAP A.1 lists under "Host reads that block a capture",
  this covers the time window's FIFO reads of live count, head and
  monotone flag and of the expiring prefix, and the emission length
  ``J`` that externalTime takes too (``ops/windows.py``
  ``TimeWindowStage``, which declares ``capturable = False``; a stage
  that sets it back to ``True`` is scanned again). The join's count read
  (``core/query/join_runtime.py`` ``materialize_joined``) and the join
  engine's occupancy mirror (``core/join/engine.py`` ``prepare_batch``)
  are host code between the join's steps, not inside a step body, so
  the rule does not see them; the join steps stay eager
  (``analysis/step_registry.py`` ``PORT_EAGER_FAMILIES``).

Shape arithmetic is static, never a device pull: ``int(x.shape[0])``,
``x.numel()``, ``len(x)`` and friends.
"""

from __future__ import annotations

import ast
from typing import List, Set

from siddhi_tpu_torch.analysis.engine import Finding, LintContext, Rule

_HOT_DIRS = ("core/query/", "core/join/", "parallel/", "ops/")
# the codebase's convention for step bodies built by closures: a NESTED
# def named `step`/`fn`/`kernel` inside a builder is the body the step
# instrument runs and the step graph captures
_KERNEL_NAMES = ("step", "fn", "kernel", "fused", "sharded", "one_dev")
_PULL_BUILTINS = ("float", "int", "bool")
_PULL_METHODS = ("item", "tolist", "cpu", "numpy")
_STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "itemsize", "nbytes")
_STATIC_CALLS = ("numel", "dim", "size", "element_size", "len")
# calls whose first argument becomes a step body
_STEP_TAKERS = ("instrument_jit", "InstrumentedJit")
_GRAPH_RUNS = ("run", "_capture")


def _call_name(fn: ast.AST):
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _is_graph_receiver(fn: ast.AST) -> bool:
    """``<...graph...>.run`` / ``._capture``: a step graph's capture."""
    if not (isinstance(fn, ast.Attribute) and fn.attr in _GRAPH_RUNS):
        return False
    recv = fn.value
    name = _call_name(recv)
    return name is not None and "graph" in name.lower()


def _step_names(tree: ast.AST) -> Set[str]:
    """Function names handed as the first argument of a step instrument
    or a step graph's capture anywhere in the module."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        if (_call_name(node.func) in _STEP_TAKERS
                or _is_graph_receiver(node.func)):
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                names.add(arg.id)
    return names


def _is_static_arg(node: ast.AST) -> bool:
    """True when the expression is shape/metadata arithmetic — static in
    a captured step, never a device pull."""
    if isinstance(node, ast.Constant):
        return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            return True
        if (isinstance(sub, ast.Call)
                and _call_name(sub.func) in _STATIC_CALLS):
            return True
    return False


def _is_allowed_pull(item: ast.withitem) -> bool:
    expr = item.context_expr
    return (isinstance(expr, ast.Call)
            and _call_name(expr.func) == "allowed_pull")


def _nested_defs(tree: ast.AST) -> Set[int]:
    """ids of the defs that sit inside another def (a builder's)."""
    nested: Set[int] = set()
    todo = [(tree, False)]
    while todo:
        node, inside = todo.pop()
        for ch in ast.iter_child_nodes(node):
            is_def = isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef))
            if is_def and inside:
                nested.add(id(ch))
            todo.append((ch, inside or is_def))
    return nested


def _declares_not_capturable(cls: ast.ClassDef) -> bool:
    for st in cls.body:
        if (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
                and st.targets[0].id == "capturable"
                and isinstance(st.value, ast.Constant)
                and st.value.value is False):
            return True
    return False


class HostPullRule(Rule):
    id = "R5"
    title = "no host pull in captured step code"

    def run(self, ctx: LintContext) -> List[Finding]:
        findings: List[Finding] = []
        for mod in ctx.modules:
            if mod.path.startswith("tests/"):
                continue
            hot = any(d in mod.path for d in _HOT_DIRS)
            handed = _step_names(mod.tree)
            if not hot and not handed:
                continue
            exempt: Set[int] = set()
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) and \
                        _declares_not_capturable(node):
                    exempt.update(id(s) for s in ast.walk(node))
            nested = _nested_defs(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if id(node) in exempt:
                    continue
                if node.name in handed or (
                        hot and id(node) in nested
                        and node.name in _KERNEL_NAMES):
                    self._scan_step(mod, node, findings)
        return findings

    def _scan_step(self, mod, func, findings) -> None:
        # the candidate's OWN body only: nested defs are host-side
        # helpers or separate candidates in their own right; a `with
        # allowed_pull():` block is a sanctioned pull site
        todo = list(ast.iter_child_nodes(func))
        body: list = []
        while todo:
            n = todo.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(n, ast.With) and any(
                    _is_allowed_pull(i) for i in n.items):
                continue
            body.append(n)
            todo.extend(ast.iter_child_nodes(n))
        for node in body:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in _PULL_BUILTINS:
                if node.args and not _is_static_arg(node.args[0]):
                    findings.append(Finding(
                        self.id, mod.path, node.lineno,
                        f"{fn.id}() on a tensor inside step "
                        f"'{func.name}' forces a synchronous host pull "
                        f"and breaks the step's capture — keep the value "
                        f"on the card or ride it in the packed __meta__"))
            elif isinstance(fn, ast.Attribute):
                if fn.attr in _PULL_METHODS:
                    findings.append(Finding(
                        self.id, mod.path, node.lineno,
                        f".{fn.attr}() inside step '{func.name}' is a "
                        f"synchronous host pull — batch it through the "
                        f"pump's meta pull, or declare the stage "
                        f"capturable = False"))
                elif (fn.attr in ("asarray", "array")
                      and isinstance(fn.value, ast.Name)
                      and fn.value.id in ("np", "numpy")):
                    findings.append(Finding(
                        self.id, mod.path, node.lineno,
                        f"np.{fn.attr}() inside step '{func.name}' "
                        f"pulls to host — step code must stay on the "
                        f"card (use torch, or hoist the host work out of "
                        f"the step)"))
                elif (fn.attr == "synchronize"
                      and isinstance(fn.value, ast.Attribute)
                      and fn.value.attr == "cuda"):
                    findings.append(Finding(
                        self.id, mod.path, node.lineno,
                        f"torch.cuda.synchronize() inside step "
                        f"'{func.name}' stalls the host on the card and "
                        f"cannot be captured"))
