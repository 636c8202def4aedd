"""R2 — typed-config-knob discipline.

Counterpart of ``siddhi_tpu/analysis/rules_config.py``, with the same
scoping: the port's registry is ``core/util/knobs.py`` and its
sanitizer ``analysis/sanitize.py``, at the same relative paths.

The regression class: every ``siddhi_tpu.*`` key used to ride a
generic ``int(v)`` loop in ``app_runtime``, so ``join_partition_grow:
'false'`` crashed with a bare ``ValueError`` and boolean/enum knobs
each grew ad-hoc spelling parsers in place. All knob reads now resolve
through the central typed parser registry
(``core/util/knobs.py``), which validates bool/int/enum spellings and
raises ``SiddhiAppValidationException`` NAMING the key and the accepted
spellings.

The rule flags:

- any ``*.get_property("siddhi_tpu....")`` call outside
  ``core/util/knobs.py`` (f-strings count — a dynamically-built key is
  still an ad-hoc read);
- any ``os.environ`` read of a ``SIDDHI_TPU_*`` variable outside the
  knob registry and the sanitizer module (env spellings deserve the
  same typed parsing as config keys);
- (the bidirectional half) any knob DECLARED in the registry that no
  production code ever reads — ``attr=None`` knobs need a
  ``read_knob(…, "key")`` literal somewhere, ``attr="x"`` knobs need
  the attribute consumed (``ctx.x`` or ``getattr(ctx, "x", …)``).
  A tunable nobody consumes is dead weight that silently does nothing
  when users set it.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from siddhi_tpu_torch.analysis.engine import Finding, LintContext, Rule

_ALLOWED = ("core/util/knobs.py", "analysis/sanitize.py")
# SIDDHI_TPU_* env vars allowed as raw reads outside the registry
# (currently none — sanitize.py's own reads are covered by _ALLOWED)
_ENV_ALLOWED_NAMES = ()


def _literal_text(node: ast.AST) -> Optional[str]:
    """The literal portion of a Str or JoinedStr ('' for pure
    interpolation)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        return "".join(v.value for v in node.values
                       if isinstance(v, ast.Constant)
                       and isinstance(v.value, str))
    return None


class ConfigKnobRule(Rule):
    id = "R2"
    title = "typed config-knob discipline"

    def run(self, ctx: LintContext) -> List[Finding]:
        findings: List[Finding] = []
        for mod in ctx.modules:
            if any(mod.path.endswith(a) for a in _ALLOWED):
                continue
            in_tests = mod.path.startswith("tests/")
            if in_tests:
                continue    # tests set knobs on purpose, any spelling
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if (isinstance(fn, ast.Attribute)
                        and fn.attr == "get_property"):
                    for arg in node.args:
                        text = _literal_text(arg)
                        if text is not None and "siddhi_tpu." in text:
                            findings.append(Finding(
                                self.id, mod.path, node.lineno,
                                f"ad-hoc read of config key "
                                f"'{text}…' — resolve it through the "
                                f"typed parser registry in "
                                f"core/util/knobs.py (read_knob / "
                                f"apply_app_knobs) so junk spellings "
                                f"raise naming the key"))
                else:
                    self._check_env(mod, node, findings)
            for node in ast.walk(mod.tree):
                # os.environ["SIDDHI_TPU_…"] subscript reads too
                if (isinstance(node, ast.Subscript)
                        and isinstance(node.value, ast.Attribute)
                        and node.value.attr == "environ"):
                    text = _literal_text(node.slice)
                    if (text and text.startswith("SIDDHI_TPU_")
                            and text not in _ENV_ALLOWED_NAMES
                            and isinstance(node.ctx, ast.Load)):
                        findings.append(Finding(
                            self.id, mod.path, node.lineno,
                            f"ad-hoc read of env var '{text}' — give "
                            f"it a typed accessor in "
                            f"core/util/knobs.py"))
        findings.extend(self._dead_knobs(ctx))
        return findings

    # ------------------------------------------------- dead-knob parity

    def _dead_knobs(self, ctx: LintContext) -> List[Finding]:
        """The reverse direction: every ``Knob(...)`` declared in the
        registry must have a production consumer. Silent when the
        linted tree has no registry at all (targeted roots, fixtures).
        """
        knobs_mod = None
        for mod in ctx.modules:
            if mod.path.endswith("core/util/knobs.py"):
                knobs_mod = mod
                break
        if knobs_mod is None:
            return []
        declared = self._declared_knobs(knobs_mod.tree)
        if not declared:
            return []
        read_keys: set = set()
        attr_reads: set = set()
        for mod in ctx.modules:
            if mod is knobs_mod or mod.path.startswith("tests/"):
                continue
            for node in ast.walk(mod.tree):
                if (isinstance(node, ast.Attribute)
                        and isinstance(node.ctx, ast.Load)):
                    attr_reads.add(node.attr)
                elif isinstance(node, ast.Call):
                    fn = node.func
                    name = (fn.attr if isinstance(fn, ast.Attribute)
                            else fn.id if isinstance(fn, ast.Name)
                            else None)
                    if name == "read_knob":
                        for arg in node.args[1:]:
                            text = _literal_text(arg)
                            if text:
                                read_keys.add(text)
                    elif name == "getattr" and len(node.args) >= 2:
                        text = _literal_text(node.args[1])
                        if text:
                            attr_reads.add(text)
        findings: List[Finding] = []
        for key in sorted(declared):
            attr, lineno = declared[key]
            alive = (key in read_keys) if attr is None \
                else (attr in attr_reads)
            if not alive:
                how = (f"read_knob(…, '{key}')" if attr is None
                       else f"a read of ctx.{attr}")
                findings.append(Finding(
                    self.id, knobs_mod.path, lineno,
                    f"knob '{key}' is declared but never read by "
                    f"production code ({how} not found) — wire up a "
                    f"consumer or drop the declaration"))
        return findings

    @staticmethod
    def _declared_knobs(tree) -> dict:
        """``{key: (attr_or_None, lineno)}`` from the registry's
        ``Knob("key", ..., attr=...)`` declarations."""
        out: dict = {}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "Knob"
                    and node.args):
                continue
            key = _literal_text(node.args[0])
            if key is None:
                continue
            attr = None
            for kw in node.keywords:
                if kw.arg == "attr":
                    attr = _literal_text(kw.value)
            out[key] = (attr, node.lineno)
        return out

    def _check_env(self, mod, node: ast.Call, findings) -> None:
        """os.environ.get("SIDDHI_TPU_…") / os.getenv(…) outside the
        registry."""
        fn = node.func
        is_env_get = (isinstance(fn, ast.Attribute) and fn.attr == "get"
                      and isinstance(fn.value, ast.Attribute)
                      and fn.value.attr == "environ")
        is_getenv = (isinstance(fn, ast.Attribute) and fn.attr == "getenv")
        if not (is_env_get or is_getenv) or not node.args:
            return
        text = _literal_text(node.args[0])
        if (text and text.startswith("SIDDHI_TPU_")
                and text not in _ENV_ALLOWED_NAMES):
            findings.append(Finding(
                self.id, mod.path, node.lineno,
                f"ad-hoc read of env var '{text}' — give it a typed "
                f"accessor in core/util/knobs.py"))
