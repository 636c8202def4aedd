#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the CUDA card:

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> ...

For each seed, in one process: one run of the cell (set-up, a window of
``--seconds``, the checked batches), the reference's numbers for the
program's outputs (the sound runs: the lower readings), and the same
numbers for the control, the reference put in the program's place one
precision lower (``control`` of the configuration's reference: the upper
readings). Prints one JSON line a seed and, last, each number's largest
program reading and smallest control reading beside its limit.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "portbench" / ".cache" / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = Spec(ROOT)
    program, control = {}, {}
    for seed in args.seeds:
        run = harness.run_cell(spec, args.workload, seed, args.seconds, False, device,
                               time.perf_counter())
        ref = spec.reference(run.config["name"])
        batches = sorted(run.outputs)
        want = ref.expected(run.traffic, batches, run.config)
        got = ref.compare(want, run.outputs)
        ctl = ref.compare(want, ref.control(run.traffic, batches, run.config))
        for k in ref.LIMITS:
            program[k] = max(program.get(k, got[k]), got[k])
            control[k] = min(control.get(k, ctl[k]), ctl[k])
        print(json.dumps({"seed": seed, "batches": batches, "failed": run.failed,
                          "program": got, "control": ctl}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": program, "upper": control, "limits": ref.LIMITS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
