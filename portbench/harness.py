"""One run of one cell: set-up, the timed window, the check, the result.

Set-up builds the configuration's deployment, makes the traffic's pool
from the seed, and sends the configuration's ``fill_batches`` and
``WARM_BATCHES`` sends to each input stream, so that every window is full
and every step shape compiled and captured before the window opens. The
window is a closed loop: the next batch is sent when the last send
returns, for ``seconds``. After it closes the program is freed, each
send is held to the row count the configuration's reference expects of
it (``rows_out``; None where that depends on the data, which ``compare``
then judges on the checked sends), and the reference judges the outputs
of ``CHECK_BATCHES`` sends: the window's first and last and the rest drawn
from the seed.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import trace as tr
from portbench.generator import Traffic, seed_sequence
from portbench.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "siddhi_tpu")
SEND_SPAN = "bench.send"
WARM_BATCHES = 3        # sends to each input stream after the fill
CHECK_BATCHES = 3       # sends a run's reference judges


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    """What one run measured and kept."""
    config: dict
    traffic: Traffic
    attempted: int = 0
    failed: int = 0
    events: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    setup_built: bool = False                       # set-up built a kernel
    latencies: list = field(default_factory=list)
    outputs: dict = field(default_factory=dict)     # checked batch -> columns
    memory_peak_bytes: int = 0
    record: object = None                           # TraceRecord, traced runs
    errors: list = field(default_factory=list)


def make_sink():
    """A stream callback that reads every output batch as a consumer would
    (one pull of its columns) and keeps the valid rows of the current
    send, stamping the host clock at each delivery."""
    from siddhi_tpu_torch import StreamCallback

    class Sink(StreamCallback):
        def __init__(self):
            self.parts, self.rows, self.last = [], 0, None

        def receive_batch(self, batch, junction):
            cols = batch.cols
            valid = np.asarray(cols["__valid__"])
            keep = [k for k in cols if k == "__ts__" or not (
                k.startswith("__") or k.endswith("?"))]
            if valid.all():
                part = {k: np.asarray(cols[k]) for k in keep}
            else:
                part = {k: np.asarray(cols[k])[valid] for k in keep}
            self.parts.append(part)
            self.rows += int(valid.sum())
            self.last = time.perf_counter()

        def take(self):
            parts, rows = self.parts, self.rows
            self.parts, self.rows, self.last = [], 0, None
            if len(parts) == 1:
                return rows, parts[0]
            if not parts:
                return rows, {}
            return rows, {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    return Sink()


def graph_replays(queries) -> int:
    """CUDA-graph replays of the queries' steps so far."""
    return sum(getattr(getattr(getattr(q, "_step", None), "graph", None), "replays", 0)
               for q in queries)


def counters(rt, queries) -> dict:
    """Counters the per-layer readers take deltas of."""
    out = {"graph.replays": float(graph_replays(queries))}
    layouts = [q._route_layout for q in queries
               if getattr(q, "_route_layout", None) is not None]
    if layouts:
        out["route.dispatches"] = float(sum(lay.dispatches for lay in layouts))
    snap = rt.app_context.telemetry.snapshot()
    for name, h in snap.get("histograms", {}).items():
        out[f"hist.{name}.count"] = float(h["count"])
        out[f"hist.{name}.sum"] = float(h["sum"])
    return out


def build_outputs() -> set:
    """Files in the port's native build directory and in the kernel caches
    the benchmark gives it: a set-up that adds one has built a kernel."""
    import siddhi_tpu_torch

    dirs = [Path(siddhi_tpu_torch.__file__).resolve().parent / "_build",
            *(Path(os.environ[k]) for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR")
              if k in os.environ)]
    return {str(f) for d in dirs if d.is_dir() for f in d.rglob("*") if f.is_file()}


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, on_deployed=None) -> Run:
    """Set up ``workload``, time it for ``seconds`` and keep its checked
    batches' outputs. ``on_deployed(rt, queries)`` runs after the
    deployment is built (the fault tests break the program there)."""
    import torch

    from siddhi_tpu_torch.observability.tracing import span

    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    ref = spec.reference(config["name"])
    built = build_outputs()
    traffic = Traffic(config, spec.mix(cell["traffic"]), seed)
    run = Run(config=config, traffic=traffic)
    m, rt, queries = spec.deployment(config["deployment"]).deploy(config, device)
    if on_deployed is not None:
        on_deployed(rt, queries)
    sink = make_sink()
    rt.add_callback(config["output_stream"], sink)
    handlers = {s: rt.get_input_handler(s) for s in traffic.streams}
    cuda = device.type == "cuda"

    def send(g):
        """One send: (raised, latency s, rows, columns)."""
        cols, ts = traffic.columns(g), traffic.timestamps(g)
        h = handlers[traffic.stream(g)]
        t_due = time.perf_counter()
        raised = False
        try:
            with span(SEND_SPAN):
                h.send_columns(cols, timestamps=ts)
        except Exception:       # a failed send is counted, and the run goes on
            raised = True
            if len(run.errors) < 3:
                run.errors.append(traceback.format_exc())
        arrived = sink.last
        rows, out = sink.take()
        done = arrived if arrived is not None else time.perf_counter()
        return raised, done - t_due, rows, out

    g = 0
    for _ in range(int(config.get("fill_batches", 0))
                   + WARM_BATCHES * len(traffic.streams)):
        send(g)
        g += 1
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    run.setup_built = build_outputs() != built

    pick = np.random.default_rng(seed_sequence(seed, 1))
    reservoir, first, last, sent = [], None, None, []
    tracing = tr.Tracing(device) if trace else None
    before, replayed = {}, 0
    if tracing is not None:
        before = counters(rt, queries)
        tracing.start()
    t_first = time.perf_counter()
    deadline = t_first + seconds
    i = 0
    while True:
        if i and time.perf_counter() >= deadline:
            break
        if tracing is not None:
            r0 = graph_replays(queries)
        raised, lat, rows, out = send(g)
        if tracing is not None and graph_replays(queries) > r0:
            replayed += 1
        sent.append((g, raised, rows))
        run.latencies.append(lat)
        if i == 0:
            first = (g, out)
        elif len(reservoir) < CHECK_BATCHES - 2:
            reservoir.append((g, out))
        elif pick.random() < (CHECK_BATCHES - 2) / i:
            reservoir[int(pick.integers(0, CHECK_BATCHES - 2))] = (g, out)
        last = (g, out)
        g += 1
        i += 1
    t_end = time.perf_counter()
    run.window_s = t_end - t_first
    run.setup_s = t_first - t_start
    if tracing is not None:
        spans, dev = tracing.stop()
        after = counters(rt, queries)
        after["batches.replayed"] = float(replayed)
        sends = [s for s in spans if s[0] == SEND_SPAN]
        rows_in = {}
        for gg, _r, _n in sent:
            s = traffic.stream(gg)
            rows_in[s] = rows_in.get(s, 0) + traffic.batch
        run.record = tr.TraceRecord(
            config=config,
            device_kind=torch.cuda.get_device_name(device) if cuda else "cpu",
            batches=len(sent), rows=rows_in, window=(sends[0][2], sends[-1][3]),
            spans=spans, device=dev, before=before, after=after)
    if cuda:
        torch.cuda.synchronize(device)
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    run.outputs = {gg: out for gg, out in [first, *reservoir, last]}
    m.shutdown()
    del m, rt, queries, sink, handlers
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # each send against the rows its configuration's reference expects
    for gg, raised, rows in sent:
        want = ref.rows_out(traffic, gg, config)
        ok = not raised and (want is None or rows == want)
        run.attempted += 1
        run.failed += not ok
        run.events += traffic.batch if ok else 0
    return run


def judge(spec: Spec, run: Run) -> dict:
    """{name: (reading, limit)} of the configuration's reference over the
    checked batches, and the failed sends against 0."""
    ref = spec.reference(run.config["name"])
    want = ref.expected(run.traffic, sorted(run.outputs), run.config)
    readings = ref.compare(want, run.outputs)
    checks = {k: (readings[k], ref.LIMITS[k]) for k in ref.LIMITS}
    checks["failed_batches"] = (run.failed, 0)
    return checks


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def result_line(spec: Spec, workload: str, run: Run, checks: dict, trace: bool,
                device) -> dict:
    """The contract's result object; ``checks`` is its last key."""
    import torch

    cell = spec.cell(workload)
    correct = passed(checks) and run.attempted > 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": run.memory_peak_bytes}
    metrics, extra = {}, {}
    if trace:
        t0 = time.perf_counter()
        rec = run.record
        dev["busy_s"] = rec.busy_s()
        dev["window_s"] = rec.window_s
        for m in spec.metrics(workload, "per_layer"):
            value = spec.metric_reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        extra["breakdown"] = tr.breakdown(rec)
        print(f"portbench: trace reduced in {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    else:
        for m in spec.metrics(workload, "end_to_end"):
            value = spec.metric_reader(m["name"]).read(run)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev, **extra,
            "setup_built": run.setup_built}
    line["checks"] = {k: {"value": _num(v), "limit": _num(lim)}
                      for k, (v, lim) in checks.items()}
    return line


def _num(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x
