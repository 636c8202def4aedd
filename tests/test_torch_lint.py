"""The port's lint engine (``siddhi_tpu_torch/analysis/engine.py`` and its
``rules_*.py``) against the reference's (``siddhi_tpu/analysis/``).

- Each of the eight rules flags its fixture. R2–R4 and R6–R8 read the
  reference's own ``tests/fixtures/lint/*.py`` (read only, loaded under
  port paths); R1 and R5, whose port counterparts are torch rules, read
  ``tests/fixtures/lint_torch/*.py``.
- Differential: on every shared fixture and on the suppression cases,
  the reference's engine and the port's give the same findings (rule,
  path under its package, line and message), given the same
  declarations (the reference's ``export.py`` for both).
- The bidirectional cases of ``tests/test_graftlint.py`` (instrument
  slots, metric prefixes, knobs), on the port's engine.
- The port's tree is clean, its command line's flags and exit codes match
  ``tools/graftlint.py``'s, the engine and the rules import the standard
  library only, and importing every module of the port initializes no
  CUDA and builds nothing (R1's runtime witness, ``chip_smoke.py
  --imports``).
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
from torch_helpers import release_jax_programs  # noqa: F401 — autouse fixture

from siddhi_tpu.analysis import engine as ref_engine
from siddhi_tpu.analysis import run_lint as ref_run_lint
from siddhi_tpu_torch.analysis import default_rules, load_modules, run_lint
from siddhi_tpu_torch.analysis.__main__ import DEFAULT_ROOTS
from siddhi_tpu_torch.analysis.__main__ import main as lint_main
from siddhi_tpu_torch.analysis.engine import ModuleInfo

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REF_FIXTURES = os.path.join(HERE, "fixtures", "lint")
TORCH_FIXTURES = os.path.join(HERE, "fixtures", "lint_torch")
PORT_EXPORT = "siddhi_tpu_torch/observability/export.py"
REF_EXPORT = "siddhi_tpu/observability/export.py"

# fixture -> (directory, virtual path under the port's package); rule
# scoping applies to the path as it would in the tree
FIXTURES = {
    "r1_backend_init.py": (TORCH_FIXTURES, "parallel/bad_backend.py"),
    "r2_adhoc_knob.py": (REF_FIXTURES, "core/bad_knobs.py"),
    "r3_metric_family.py": (REF_FIXTURES, "observability/bad_metrics.py"),
    "r3_stage_family.py": (REF_FIXTURES, "observability/bad_stage_metrics.py"),
    "r4_lock_order.py": (REF_FIXTURES, "core/query/bad_locks.py"),
    "r5_host_pull.py": (TORCH_FIXTURES, "core/query/bad_steps.py"),
    "r6_instruments.py": (REF_FIXTURES, "core/query/bad_instruments.py"),
    "r7_actuators.py": (REF_FIXTURES, "autopilot/bad_actuators.py"),
    "r8_guards.py": (REF_FIXTURES, "core/query/bad_guards.py"),
}
SHARED = [n for n, (d, _p) in FIXTURES.items() if d == REF_FIXTURES]


def _port_fixture(name: str) -> ModuleInfo:
    d, rel = FIXTURES[name]
    return ModuleInfo.load(os.path.join(d, name), "siddhi_tpu_torch/" + rel)


def _lint_port_fixture(name: str):
    # the port's own export.py supplies the R3/R6 declarations
    export = ModuleInfo.load(os.path.join(REPO, PORT_EXPORT), PORT_EXPORT)
    mod = _port_fixture(name)
    return [f for f in run_lint([mod, export]) if f.path == mod.path]


@pytest.mark.parametrize("name,rule,min_hits", [
    # tensor, CUDA call, kernel build, CDLL, default device, default-arg
    # tensor + .cuda(), class-body tensor
    ("r1_backend_init.py", "R1", 3),
    ("r2_adhoc_knob.py", "R2", 3),     # f-string key, literal key, env var
    ("r3_metric_family.py", "R3", 3),  # prefix x2 + family literal
    ("r3_stage_family.py", "R3", 2),   # unremoved stage gauge + family
    ("r4_lock_order.py", "R4", 2),     # pump->owner and owner->barrier
    # float, .item, np.asarray, .cpu, bool, .tolist, synchronize, .numpy
    ("r5_host_pull.py", "R5", 4),
    ("r6_instruments.py", "R6", 2),    # undeclared data + consumer-less check
    ("r7_actuators.py", "R7", 3),      # untyped knob, dead, undeclared path
    ("r8_guards.py", "R8", 4),         # stale, unlocked write/read, threads
])
def test_rule_flags_its_fixture(name, rule, min_hits):
    findings = _lint_port_fixture(name)
    hits = [f for f in findings if f.rule == rule]
    assert len(hits) >= min_hits, (
        f"{name}: wanted >= {min_hits} {rule} findings, got "
        f"{[f.format() for f in findings]}")
    # each fixture is crafted for exactly one rule
    assert len(hits) == len(findings), [f.format() for f in findings]


def test_torch_fixtures_flag_exactly_their_lines():
    """R1 and R5 on the torch fixtures: every marked line, and no line
    the fixture calls fine (lazy bodies, is_available, the main guard,
    shape arithmetic, allowed_pull, a stage declared not capturable)."""
    r1 = sorted(f.line for f in _lint_port_fixture("r1_backend_init.py"))
    # line 25: the default's factory and its .cuda()
    assert r1 == [12, 13, 14, 15, 16, 25, 25, 30], r1
    r5 = [(f.line, f.message.split(" ", 1)[0])
          for f in _lint_port_fixture("r5_host_pull.py")]
    assert sorted(r5) == [(13, "float()"), (14, ".item()"), (15, ".cpu()"),
                          (15, "np.asarray()"), (16, "bool()"),
                          (18, ".tolist()"), (19, "torch.cuda.synchronize()"),
                          (31, ".numpy()")], r5


# ------------------------------------------------------------ differential

def _to_ref_path(path: str) -> str:
    assert path.startswith("siddhi_tpu_torch/"), path
    return "siddhi_tpu/" + path[len("siddhi_tpu_torch/"):]


def _both(port_mods, ref_mods):
    """(port findings with paths mapped to the reference's package,
    reference findings) as sorted tuples."""
    port = sorted((f.rule, _to_ref_path(f.path), f.line, f.message)
                  for f in run_lint(port_mods))
    ref = sorted((f.rule, f.path, f.line, f.message)
                 for f in ref_run_lint(ref_mods))
    return port, ref


@pytest.mark.parametrize("name", SHARED)
def test_differential_shared_fixture(name):
    """The same fixture and the same declarations (the reference's
    export.py, at each package's path): the same findings, export.py's
    dead-declaration findings included."""
    export_src = os.path.join(REPO, REF_EXPORT)
    rel = FIXTURES[name][1]
    port_mods = [ModuleInfo.load(os.path.join(REF_FIXTURES, name),
                                 "siddhi_tpu_torch/" + rel),
                 ModuleInfo.load(export_src, PORT_EXPORT)]
    ref_mods = [ref_engine.ModuleInfo.load(os.path.join(REF_FIXTURES, name),
                                           "siddhi_tpu/" + rel),
                ref_engine.ModuleInfo.load(export_src, REF_EXPORT)]
    port, ref = _both(port_mods, ref_mods)
    assert port == ref
    assert any(r[1] == "siddhi_tpu/" + rel for r in ref), ref


_ENV_READ = 'V{i} = os.environ.get("SIDDHI_TPU_X{i}")'
SUPPRESSION_CASES = {
    "line": ["import os", _ENV_READ.format(i=1) + "  # graftlint: disable=R2",
             _ENV_READ.format(i=2)],
    "line_all": ["import os", _ENV_READ.format(i=1) + "  # graftlint: disable=all",
                 _ENV_READ.format(i=2)],
    "line_list": ["import os",
                  _ENV_READ.format(i=1) + "  # graftlint: disable=R1, R2",
                  _ENV_READ.format(i=2) + "  # graftlint: disable=R3"],
    "file": ["# graftlint: disable-file=R2", "import os",
             _ENV_READ.format(i=1), _ENV_READ.format(i=2)],
    "file_other_rule": ["import os", "# graftlint: disable-file=R4",
                        _ENV_READ.format(i=1)],
}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
def test_differential_suppressions(case, tmp_path):
    src = "\n".join(SUPPRESSION_CASES[case]) + "\n"
    path = tmp_path / "s.py"
    path.write_text(src)
    port, ref = _both([ModuleInfo.load(str(path), "siddhi_tpu_torch/core/s.py")],
                      [ref_engine.ModuleInfo.load(str(path), "siddhi_tpu/core/s.py")])
    assert port == ref
    want = {"line": [3], "line_all": [3], "line_list": [3], "file": [],
            "file_other_rule": [3]}[case]
    assert [r[2] for r in port] == want, port


def test_torch_rule_suppression(tmp_path):
    """test_graftlint.py's suppression case, on the torch rule R1."""
    src = ("import torch\n"
           "X = torch.zeros(1)  # graftlint: disable=R1 — a test constant\n"
           "Y = torch.zeros(2)\n")
    path = tmp_path / "s.py"
    path.write_text(src)
    findings = run_lint([ModuleInfo.load(str(path), "siddhi_tpu_torch/s.py")])
    assert [(f.rule, f.line) for f in findings] == [("R1", 3)], findings
    path.write_text("# graftlint: disable-file=R1\n" + src)
    assert not run_lint([ModuleInfo.load(str(path), "siddhi_tpu_torch/s.py")])


# ----------------------------------------------------- bidirectional cases

def _mods(**srcs):
    return [ModuleInfo(path=p, src=s, tree=ast.parse(s)) for p, s in srcs.items()]


def test_instrument_parity_bidirectional():
    exp_src = ('TELEMETRY_PREFIXES = ("device",)\n'
               'PROCESS_LIFETIME_GAUGES = ("device.*",)\n'
               'DEVICE_SLOTS = ("win_fill", "never_computed")\n'
               'DEVICE_CHECK_SLOTS = ("seq",)\n')
    reg_src = ('from siddhi_tpu_torch.observability.instruments import Slot\n'
               'def wire(tel, q):\n'
               '    tel.gauge(f"device.{q}.win_fill", lambda: 0)\n'
               'def spec():\n'
               '    return [Slot("win_fill"), Slot("seq", kind="check")]\n'
               'class R:\n'
               '    def _consume_check_slot(self, name, vals):\n'
               '        if name == "seq":\n'
               '            pass\n')
    findings = [f for f in run_lint(_mods(**{
        PORT_EXPORT: exp_src, "siddhi_tpu_torch/core/wire.py": reg_src}))
        if f.rule == "R6"]
    assert findings and all("never_computed" in f.message for f in findings), \
        [f.format() for f in findings]


def test_metric_prefix_parity_bidirectional():
    exp_src = ('TELEMETRY_PREFIXES = ("junction", "ghost")\n'
               'PROCESS_LIFETIME_GAUGES = ("junction.*",)\n')
    reg_src = ('def wire(tel, sid):\n'
               '    tel.gauge(f"junction.{sid}.queue_depth", lambda: 0)\n')
    findings = run_lint(_mods(**{
        PORT_EXPORT: exp_src, "siddhi_tpu_torch/core/wire.py": reg_src}))
    assert [f.path for f in findings if "ghost" in f.message] == [PORT_EXPORT], \
        [f.format() for f in findings]
    assert not [f for f in findings if "junction" in f.message], findings


def test_knob_parity_bidirectional():
    reg_src = ('KNOBS = _declare(\n'
               '    Knob("window_capacity", "int",'
               ' attr="window_capacity"),\n'
               '    Knob("ghost_attr", "int", attr="ghost_attr"),\n'
               '    Knob("quota_queue_depth", "int"),\n'
               '    Knob("ghost_key", "float"),\n'
               ')\n')
    use_src = ('def wire(ctx, cm):\n'
               '    cap = getattr(ctx, "window_capacity", 4096)\n'
               '    depth = read_knob(cm, "quota_queue_depth")\n'
               '    return cap, depth\n')
    msgs = [f.message for f in run_lint(_mods(**{
        "siddhi_tpu_torch/core/util/knobs.py": reg_src,
        "siddhi_tpu_torch/core/wire.py": use_src})) if f.rule == "R2"]
    assert any("ghost_attr" in m for m in msgs), msgs
    assert any("ghost_key" in m for m in msgs), msgs
    assert not any("window_capacity" in m or "quota_queue_depth" in m
                   for m in msgs), msgs


# ------------------------------------------------------- the port's tree

def test_port_tree_is_clean():
    """``python -m siddhi_tpu_torch.analysis`` over the default roots
    (siddhi_tpu_torch, chip_smoke.py, distinct_bench.py): exit 0."""
    proc = subprocess.run([sys.executable, "-m", "siddhi_tpu_torch.analysis"],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1].startswith(
        "graftlint: 0 findings across "), proc.stdout


def test_every_suppression_names_its_reason():
    """A suppression in the port carries its reason on the line: text
    after the rule ids (an em dash, then why)."""
    bare = []
    for mod in load_modules(DEFAULT_ROOTS, REPO):
        if mod.path.startswith("siddhi_tpu_torch/analysis/"):
            continue    # the engine's own docs quote the grammar
        for i, line in enumerate(mod.src.splitlines(), 1):
            _pre, sep, rest = line.partition("# graftlint: disable")
            if sep and " — " not in rest:
                bare.append(f"{mod.path}:{i}: {line.strip()}")
    assert not bare, bare


def test_rule_registry_lists_eight_rules():
    assert [r.id for r in default_rules()] == [
        "R1", "R2", "R3", "R4", "R5", "R6", "R7", "R8"]


_RULE_FILES = sorted(
    f for f in os.listdir(os.path.join(REPO, "siddhi_tpu_torch", "analysis"))
    if f in ("engine.py", "lockorder.py") or f.startswith("rules_"))


@pytest.mark.parametrize("name", _RULE_FILES)
def test_engine_and_rules_import_only_the_standard_library(name):
    """From each file's AST: every import is the standard library or a
    stdlib-only module of the engine (the engine, the rules, lockorder)."""
    own = {"siddhi_tpu_torch.analysis", "siddhi_tpu_torch.analysis.engine",
           "siddhi_tpu_torch.analysis.lockorder"} | {
        "siddhi_tpu_torch.analysis." + f[:-3] for f in _RULE_FILES}
    path = os.path.join(REPO, "siddhi_tpu_torch", "analysis", name)
    bad = []
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
            if node.module == "siddhi_tpu_torch.analysis":
                mods = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for m in mods:
            if m in own or m == "__future__":
                continue
            if m.split(".", 1)[0] not in sys.stdlib_module_names:
                bad.append(m)
    assert len(_RULE_FILES) == 10
    assert not bad, f"{name} imports {bad}"


# ------------------------------------------------------ the command line

def test_cli_lists_the_rules(capsys):
    assert lint_main(["--list"]) == 0
    assert [ln.split()[0] for ln in capsys.readouterr().out.splitlines()] == [
        f"R{i}" for i in range(1, 9)]


def test_cli_json_and_exit_codes_match_the_reference(tmp_path, capsys):
    # outside tests/ (R2 skips tests/): an absolute root, the same for both
    fixture = str(tmp_path / "adhoc_knob.py")
    with open(os.path.join(REF_FIXTURES, "r2_adhoc_knob.py")) as f:
        open(fixture, "w").write(f.read())
    assert lint_main(["--json", fixture]) == 1
    pj = json.loads(capsys.readouterr().out)
    ref = subprocess.run([sys.executable, os.path.join(REPO, "tools", "graftlint.py"),
                          "--json", fixture], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert ref.returncode == 1, ref.stdout + ref.stderr
    rj = json.loads(ref.stdout)
    assert set(pj) == set(rj) == {"findings", "files", "rules"}
    assert pj["rules"] == rj["rules"] and pj["files"] == rj["files"] == 1
    assert pj["findings"] == rj["findings"] and len(pj["findings"]) >= 3
    # a root that does not exist, and a tree with no Python file: 2
    assert lint_main(["no/such/root"]) == 2
    assert lint_main([os.path.join("siddhi_tpu_torch", "csrc")]) == 2
    # a file that does not parse: 1, in the finding format
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    capsys.readouterr()
    assert lint_main([str(broken)]) == 1
    assert ": parse: " in capsys.readouterr().out


def test_importing_the_port_initializes_no_cuda_and_builds_nothing():
    """R1's runtime witness: a child process imports every module of the
    package; CUDA stays uninitialized and ``_build/`` gains no file."""
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                           "--imports"], capture_output=True, text=True,
                          timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("IMPORTS ")]
    facts = json.loads(line[0][len("IMPORTS "):])
    assert facts["cuda_initialized"] is False
    assert facts["built"] == [], facts
    assert facts["modules"] > 100, facts
