"""The user-facing examples (``examples/01``-``07``) on the port, on the CPU.

Each example runs in a subprocess with its imports re-bound to the port
(``torch_helpers.port_source``, as ``port_corpus`` re-binds a corpus) and
its managers on the CPU, and must exit 0 having printed its output.
``07_multichip_sharding.py`` runs without its ``force_host_devices`` lines:
on torch there is no virtual device platform to force, since
``make_mesh(n)`` is n logical shards of the one device (MIGRATION.md).
The examples themselves stay as they are.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_helpers import release_jax_programs  # noqa: F401 — autouse fixture

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("0*.py"))

CHILD = """
import sys

root, path = sys.argv[1:3]
sys.path[:0] = [root, root + "/tests"]
import torch

torch.set_num_threads(1)
import torch_helpers

with open(path) as f:
    src = f.read()
src = "\\n".join(line for line in src.splitlines() if "force_host_devices" not in line)
src = torch_helpers.port_source(src)
assert "import siddhi_tpu\\n" not in src and "from siddhi_tpu " not in src, src
exec(compile(src, path, "exec"), {"__name__": "__main__", "__file__": path})
bad = [k for k in sys.modules if k in ("jax", "siddhi_tpu")
       or k.startswith(("jax.", "siddhi_tpu."))]
assert not bad, bad
"""


def test_seven_examples():
    assert EXAMPLES == [f"0{i}_{n}" for i, n in enumerate(
        ("filter_stream.py", "window_aggregation.py", "pattern_detection.py",
         "partitions_and_tables.py", "transport_and_persistence.py",
         "rest_service.py", "multichip_sharding.py"), start=1)]


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_runs_on_the_port(example):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(ROOT), str(ROOT / "examples" / example)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.strip(), proc.stderr[-2000:]
