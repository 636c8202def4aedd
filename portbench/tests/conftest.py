"""Fixtures of the benchmark's CPU tests: a copy of the checkout's
benchmark cut to a size the CPU runs in a second (``tiny_root``).

    python -m pytest portbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every configuration and mix of the checkout, cut: windows, keys, slots
# and batches small enough for the CPU, the shapes kept
TINY = {"keys": 100, "part_window": 8, "distinct_window": 40, "key_slots": 128,
        "rows_per_shard": 256, "distinct_capacity": 64, "fill_batches": 6,
        "batch": 256, "pool_batches": 5}


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["keys"]["count"] = TINY["keys"]
    old = cfg["window"]
    cfg["window"] = TINY["distinct_window" if "distinct" in cfg else "part_window"]
    cfg["app"] = cfg["app"].replace(f"length({old})", f"length({cfg['window']})")
    if "key_slots" in cfg:
        cfg["key_slots"] = TINY["key_slots"]
    if "route" in cfg:
        cfg["route"]["rows_per_shard"] = TINY["rows_per_shard"]
    if "distinct" in cfg:
        cfg["distinct"]["capacity"] = TINY["distinct_capacity"]
    cfg["fill_batches"] = TINY["fill_batches"]
    return cfg


def make_tiny_root(dest: Path) -> Path:
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        (dest / c["file"]).write_text(json.dumps(tiny_config(cfg)))
    for mix in (ROOT / "portbench" / "traffic").glob("*.json"):
        m = json.loads(mix.read_text())
        m["batch"], m["pool_batches"] = TINY["batch"], TINY["pool_batches"]
        (dest / "portbench" / "traffic" / mix.name).write_text(json.dumps(m))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import torch

    torch.set_num_threads(2)
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def tiny_spec(tiny_root):
    from portbench.spec import Spec

    return Spec(tiny_root)


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
