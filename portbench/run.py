#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the CUDA card, from the root
of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints each compared number beside its limit as the last lines of
standard error, and one JSON result object as the last line of standard
output; its ``setup_built`` says whether set-up built a kernel, as the
first run in a checkout does. It exits with another code than 0, and
prints no result, where the card is missing or the cell asks for more
cards than there are, or where a module of JAX or of the JAX package
``siddhi_tpu`` was loaded by the time the result is ready. The kernels'
build and compile caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), "
              f"found {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START)
    return finish(spec, args.workload, run, bool(args.trace), device)


def finish(spec, workload: str, run, trace: bool, device) -> int:
    """Judge ``run``, read its metrics and print the result, unless a
    module of JAX or of the JAX package was loaded by then, by the program,
    the reference or a metric reader: then exit 3 and print none."""
    from portbench import harness

    for err in run.errors:
        print(err, file=sys.stderr)
    checks = harness.judge(spec, run)
    line = harness.result_line(spec, workload, run, checks, trace, device)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(f"portbench: setup_s {run.setup_s:.3f}, set-up built a kernel: "
          f"{run.setup_built}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
