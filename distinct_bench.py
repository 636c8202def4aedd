#!/usr/bin/env python3
"""The distinct scan's whole call, timed on one CUDA card, for this
checkout or another one, so that two versions compare in one run.

    python3 distinct_bench.py record OUT.pt          # the inputs, from this checkout
    python3 distinct_bench.py time OUT.pt [--root DIR]

``record`` drives chip_smoke.py's phase 9 apps through the public API and
keeps the arguments of one distinct-scan call of each: D1 (the global
flagship's shape with ``distinctCount(volume)`` group by symbol, H = 64,
batch 3), D2 (``distinctCount(symbol)`` over ``#window.length(1000)``,
one group, H = 1,024, batch 3) and D3 (the same over
``#window.length(10000)``, H = 8,192, batch 3). ``time`` runs the
``distinct_scan`` of the checkout at ``--root`` (default: this one) on
them, each call on a fresh copy of the state, and prints one JSON line a
shape: CUDA-event ms of the call with the L2 cache flushed, the device
ms of every kernel the call launches (torch.profiler, the flush left
out) and by kernel, and the host ms to enqueue it. A checkout whose
kernel does not take the shape's H says so.
"""

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHAPES = {"D1": ("D1", 1000, None), "D2": ("D2", 1000, 1024),
          "D3": ("D2", 10_000, 8192)}        # (app, window, capacity)
RUNS = {"D1": 30, "D2": 10, "D3": 10}
N_BATCHES = 3


def smoke():
    """This checkout's chip_smoke.py (its feed, apps and timers), whichever
    package ``siddhi_tpu_torch`` resolves to."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(out: str) -> None:
    import torch

    sys.path.insert(0, str(HERE))
    cs = smoke()
    device = torch.device("cuda", 0)
    feed = cs.make_feed(5, N_BATCHES, cs.BATCH, cs.NUM_SYMBOLS)
    saved = {}
    for name, (app, window, cap) in SHAPES.items():
        text = (cs.D1_APP if app == "D1" else cs.D2_APP).format(W=window)
        with cs.recording(at=N_BATCHES - 1) as rec:
            cs.run_app(device, text, feed, key_slots=cs.KEY_SLOTS if app == "D1" else None,
                       capacity=cap)
        saved[name] = ([None if a is None else a.cpu() for a in rec.args], rec.kwargs)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, out)
    print(f"recorded {', '.join(saved)} into {out}")


def device_by_kernel(fn, flush, runs):
    """{kernel name: device ms per call} over ``runs`` calls of ``fn``,
    each after the flush (a bitwise_not over 100 MB, left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "bitwise_not" not in e.key:
            out[e.key[:120]] = (out.get(e.key[:120], 0.0)
                                + e.self_device_time_total / 1e3 / runs)
    return out


def time_root(inputs: str, root: str) -> None:
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    cs = smoke()
    from siddhi_tpu_torch.ops import distinct

    card = cs.card_line()
    device = torch.device("cuda", 0)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    saved = torch.load(inputs)
    for name, (args, kwargs) in saved.items():
        args = [None if a is None else a.to(device) for a in args]
        state, rows = args[:3], args[3:]
        H = state[0].shape[1]
        line = {"root": str(root), "shape": name, "H": H, "card": card}
        if H > getattr(distinct, "MAX_H", H):
            line["unsupported"] = f"the kernel takes H <= {distinct.MAX_H}"
            print(json.dumps(line), flush=True)
            continue
        runs = RUNS[name]

        def calls(fn, n):
            pool = [[t.clone() for t in state] for _ in range(n + 1)]
            return lambda: fn(*pool.pop(), *rows, **kwargs)

        line["ms"] = cs.time_ms(calls(distinct.distinct_scan, runs), runs=runs,
                                flush=flush)
        line["host_ms"] = cs.host_ms(calls(distinct.distinct_scan, runs), runs=runs)
        kernels = device_by_kernel(calls(distinct.distinct_scan, runs), flush, runs)
        line["call_device_ms"] = sum(kernels.values())
        line["scan_device_ms"] = sum(v for k, v in kernels.items()
                                     if "distinct_scan" in k)
        line["kernels"] = kernels
        print(json.dumps(line), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("distinct_bench: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) >= 3 and sys.argv[1] == "record":
        record(sys.argv[2])
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "time":
        root = str(HERE)
        if "--root" in sys.argv:
            root = sys.argv[sys.argv.index("--root") + 1]
        time_root(sys.argv[2], root)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"distinct_bench: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
