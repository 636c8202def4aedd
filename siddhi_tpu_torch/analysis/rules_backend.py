"""R1 — no CUDA initialisation and no tensor at import.

The torch counterpart of ``siddhi_tpu/analysis/rules_backend.py``. The
reference's breaker class was a module-level ``jnp.int64(...)`` constant
that initialized the jax backend at import, before the virtual mesh was
configured. Its torch form is anything that touches the card, makes a
tensor or loads a kernel while a module is imported: the tests import
every module on hosts with no card, no ``nvcc`` and no ``triton``; a
child process (``chip_smoke.py`` phase 30) checks that importing the
whole package leaves ``torch.cuda.is_initialized()`` False and builds
nothing. The rule flags, wherever code runs at import (module level,
class bodies, default argument values and decorators; the body of a
``if __name__ == "__main__":`` block does not):

- ``torch.cuda.<fn>(...)`` calls other than ``is_available``;
- tensor factories (``torch.tensor``, ``zeros``, ``ones``, ``empty``,
  ``full``, ``arange``, ... and their ``_like`` forms) and the
  ``.cuda()``/``.to(...)`` moves;
- building or loading a kernel or a native library: the port's
  ``ops/_cuda.py`` ``build``/``load``, ``native`` ``build_*``/``*_lib``,
  ``ctypes.CDLL``/``PyDLL``/``cdll.LoadLibrary`` and torch's own
  extension loaders;
- ``torch.set_default_device`` (and ``set_default_tensor_type``).

Names resolve through the module's imports (``import torch as th``,
``from torch import zeros``, ``from torch.cuda import synchronize``,
``from siddhi_tpu_torch.ops import _cuda``, relative imports too).

Fix pattern: a constant is numpy or Python (``np.int64(2**62)``
promotes identically inside torch arithmetic), and whatever needs the
card is made lazily inside a function.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from siddhi_tpu_torch.analysis.engine import Finding, LintContext, Rule

# torch.<name>(...) calls that make a tensor
_FACTORIES = frozenset({
    "tensor", "as_tensor", "asarray", "from_numpy", "frombuffer", "zeros",
    "ones", "empty", "full", "arange", "range", "linspace", "logspace", "eye",
    "rand", "randn", "randint", "randperm", "normal", "zeros_like",
    "ones_like", "empty_like", "full_like", "rand_like", "randn_like",
    "randint_like", "empty_strided", "scalar_tensor", "stack", "cat",
    "Tensor", "LongTensor", "IntTensor", "FloatTensor", "DoubleTensor",
    "BoolTensor", "ByteTensor",
})
# torch.<name>(...) calls that set a process-wide default device
_DEFAULT_DEVICE = frozenset({"set_default_device", "set_default_tensor_type"})
# fully qualified callables that build or load a kernel or native library
_LOADERS = frozenset({
    "ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
    "ctypes.pydll.LoadLibrary", "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline", "torch.ops.load_library",
    "siddhi_tpu_torch.ops._cuda.build", "siddhi_tpu_torch.ops._cuda.load",
})
# functions of siddhi_tpu_torch.native that build or load its libraries
_NATIVE = "siddhi_tpu_torch.native"


def _package_of(path: str) -> List[str]:
    """The dotted package a repo-relative module path lives in."""
    parts = path[:-3].split("/") if path.endswith(".py") else path.split("/")
    return parts[:-1]


def _import_table(mod) -> Dict[str, str]:
    """Local name -> the fully qualified name it is bound to."""
    table: Dict[str, str] = {}
    pkg = _package_of(mod.path)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    table[a.asname] = a.name
                else:
                    head = a.name.split(".", 1)[0]
                    table[head] = head
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - (node.level - 1)] if node.level > 1 else pkg
                module = ".".join(base + ([node.module] if node.module else []))
            else:
                module = node.module or ""
            for a in node.names:
                table[a.asname or a.name] = f"{module}.{a.name}"
    return table


def _dotted(node: ast.AST, table: Dict[str, str]) -> Optional[str]:
    """Fully qualified name of a Name/Attribute chain, or None."""
    attrs = []
    while isinstance(node, ast.Attribute):
        attrs.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    head = table.get(node.id)
    if head is None:
        return None
    return ".".join([head] + attrs[::-1])


class BackendInitRule(Rule):
    id = "R1"
    title = "no CUDA init or tensor at import"

    def run(self, ctx: LintContext) -> List[Finding]:
        findings: List[Finding] = []
        for mod in ctx.modules:
            table = _import_table(mod)
            self._scan_body(mod, mod.tree.body, table, findings)
        return findings

    # ------------------------------------------------------------------

    def _scan_body(self, mod, body, table, findings) -> None:
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # the BODY runs lazily, but defaults and decorators
                # evaluate at import time
                for n in (st.args.defaults
                          + [d for d in st.args.kw_defaults if d is not None]
                          + st.decorator_list):
                    self._scan_expr(mod, n, table, findings)
                continue
            if isinstance(st, ast.ClassDef):
                for n in st.decorator_list + st.bases:
                    self._scan_expr(mod, n, table, findings)
                self._scan_body(mod, st.body, table, findings)
                continue
            if isinstance(st, ast.If) and self._is_main_guard(st.test):
                # `if __name__ == "__main__":` runs as a script entry
                # point, never at import
                continue
            self._scan_expr(mod, st, table, findings)

    @staticmethod
    def _is_main_guard(test: ast.AST) -> bool:
        return (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id == "__name__")

    @staticmethod
    def _walk_eager(node):
        """ast.walk that does not descend into lazily-evaluated bodies
        (functions and lambdas defined at module level run later) —
        but a nested def's defaults and decorators DO evaluate at
        import, even inside a module-level if/try block."""
        todo = [node]
        while todo:
            n = todo.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                todo.extend(n.args.defaults)
                todo.extend(d for d in n.args.kw_defaults if d is not None)
                todo.extend(n.decorator_list)
                continue
            if isinstance(n, ast.Lambda):
                todo.extend(n.args.defaults)
                todo.extend(d for d in n.args.kw_defaults if d is not None)
                continue
            if isinstance(n, ast.ClassDef):
                # a nested class body runs at import as well
                todo.extend(n.decorator_list)
                todo.extend(n.bases)
                todo.extend(n.body)
                continue
            todo.extend(ast.iter_child_nodes(n))

    def _scan_expr(self, mod, node, table, findings) -> None:
        for sub in self._walk_eager(node):
            if not isinstance(sub, ast.Call):
                continue
            msg = self._classify(sub.func, table)
            if msg is not None:
                findings.append(Finding(self.id, mod.path, sub.lineno, msg))

    @staticmethod
    def _classify(fn: ast.AST, table: Dict[str, str]) -> Optional[str]:
        name = _dotted(fn, table)
        if name is not None:
            parts = name.split(".")
            if name.startswith("torch.cuda.") and parts[-1] != "is_available":
                return (f"module-level {name}() runs at import and can "
                        f"initialize CUDA — defer it into a function")
            if len(parts) == 2 and parts[0] == "torch":
                if parts[1] in _FACTORIES:
                    return (f"module-level {name}() makes a tensor at "
                            f"import — use numpy or Python for a constant, "
                            f"or make it lazily inside a function")
                if parts[1] in _DEFAULT_DEVICE:
                    return (f"module-level {name}() sets a process-wide "
                            f"default device at import — pass the device "
                            f"explicitly where tensors are made")
            if name in _LOADERS or (
                    name.startswith(_NATIVE + ".")
                    and (parts[-1].startswith("build")
                         or parts[-1].endswith("_lib"))):
                return (f"module-level {name}() builds or loads a kernel "
                        f"library at import — build it at first use, "
                        f"inside the function that launches it")
        if isinstance(fn, ast.Attribute) and fn.attr in ("cuda", "to") \
                and name != "torch.cuda":
            return (f"module-level .{fn.attr}() moves a tensor to a device "
                    f"at import — make it lazily inside a function")
        return None
