"""graftlint for the port — static analysis of its own regression classes.

Counterpart of ``tools/graftlint.py``: runs the AST rule suite of
``siddhi_tpu_torch/analysis/`` over the port (``siddhi_tpu_torch/`` and
the repo-root scripts ``chip_smoke.py`` and ``distinct_bench.py``) and
exits nonzero on any finding:

  R1  no CUDA init or tensor at import (torch.cuda calls, tensor
      factories, kernel builds and loads at module level)
  R2  typed config-knob discipline (siddhi_tpu.* reads outside knobs.py,
      knobs declared but never read)
  R3  metric-registration parity (undeclared families, unpaired gauges)
  R4  lock-order discipline (acquisitions inverting lockorder.py)
  R5  no host pulls in captured step code
  R6  device-instrument parity
  R7  actuator parity
  R8  guarded-by lock coverage (GUARDED_BY field contracts)

Usage, from the repository root:
    python -m siddhi_tpu_torch.analysis            # lint the port, exit 0/1
    python -m siddhi_tpu_torch.analysis --list     # print the rule set
    python -m siddhi_tpu_torch.analysis --json     # findings as JSON
    python -m siddhi_tpu_torch.analysis PATH...    # lint specific roots

Exit codes: 0 clean, 1 findings or a file that does not parse, 2 a root
that does not exist or a tree with no Python file.

Suppress a deliberate exception with ``# graftlint: disable=R1`` on the
line (or ``disable-file=R1`` anywhere in the file), and say why on the
same line — suppressions are reviewable, silent drift is not. The rules
import the standard library only: the linter touches no device.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_ROOTS = ("siddhi_tpu_torch", "chip_smoke.py", "distinct_bench.py")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from siddhi_tpu_torch.analysis import default_rules, load_modules, run_lint

    rules = default_rules()
    if "--list" in argv:
        for r in rules:
            print(f"{r.id}  {r.title}")
        return 0
    as_json = "--json" in argv
    roots = [a for a in argv if not a.startswith("-")] or list(DEFAULT_ROOTS)
    missing = [r for r in roots if not os.path.exists(os.path.join(REPO, r))]
    if missing:
        print(f"graftlint: root(s) do not exist: {missing}")
        return 2
    try:
        modules = load_modules(roots, REPO)
    except SyntaxError as e:
        # a mid-edit broken file gets the finding format, not a traceback
        print(f"{e.filename}:{e.lineno}: parse: {e.msg}")
        return 1
    if not modules:
        # a gate that checks nothing must not report success
        print(f"graftlint: no Python files under {roots}")
        return 2
    findings = run_lint(modules, rules=rules)
    if as_json:
        # one record per finding and a summary; exit codes as in text mode
        print(json.dumps({
            "findings": [{"rule": f.rule, "path": f.path, "line": f.line,
                          "message": f.message} for f in findings],
            "files": len(modules),
            "rules": [r.id for r in rules],
        }, indent=2))
        return 1 if findings else 0
    for f in findings:
        print(f.format())
    n = len(findings)
    print(f"graftlint: {n} finding{'s' if n != 1 else ''} across "
          f"{len(modules)} files ({', '.join(r.id for r in rules)})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
