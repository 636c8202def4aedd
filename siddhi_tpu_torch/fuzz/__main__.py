"""Semantic fuzzing soak: generated SiddhiQL corpus vs the strategy matrix.

Counterpart of the reference's ``tools/fuzz_equivalence.py``, with the
same flags plus ``--device``. Generates a seeded corpus of typed,
random-but-valid SiddhiQL apps (``fuzz/generator.py``: a seed gives the
reference's corpus), runs each case's deterministic feed through EVERY
live strategy combination — fan-out fusion on/off x pipeline depth {1,4}
x device-routed shard count {1,2,4} x join engine {legacy, device P=1,
device P=8} x ingest pool {0,2} — on one device, and diffs every output
stream exactly (values AND order) against the all-legacy baseline,
auditing the eligibility census for unexplained fallbacks. Divergences
are shrunk to a minimal repro and written as self-contained fixtures in
the reference's format.

    python -m siddhi_tpu_torch.fuzz --seed 0 --cases 200          # the card
    python -m siddhi_tpu_torch.fuzz --device cpu --quick
    python -m siddhi_tpu_torch.fuzz --plant --fixture-dir /tmp/fz ...
    python -m siddhi_tpu_torch.fuzz --cluster --device cuda

Budgets: ``--time-budget`` stops cleanly between cases (the report
records how far it got and ``budget_exhausted: true``); ``--max-combos``
caps the per-case matrix with a coverage-preserving sample (dropped
counts reported). The JSON report also names the device, the card
(``torch.cuda.get_device_name``, null off the card) and the kernel
wrappers' launch counts over the run, and lists the port's declared gaps
(``NOT_PORTED`` census rows, ``fuzz/runner.py``).

Exit code 0 iff every diffed pair matched, the census audit is clean
AND no run's junctions logged a processing error (a dropped batch,
``logged_errors`` in the report). In planted mode (--plant or
SIDDHI_TPU_FUZZ_PLANT=1) the contract INVERTS: exit 0 iff the
deliberately skewed strategy output WAS caught and shrunk to a <= 3-clause
repro.
"""

import argparse
import json
import os
import sys
import tempfile
import time

N_SHARDS = 4


def _kernel_launches() -> dict:
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    return {"distinct_scan": int(distinct_scan.launches),
            "ring_exchange": int(ring_exchange.launches)}


def _device_fields(device, before: dict) -> dict:
    import torch

    dev = torch.device(device)
    after = _kernel_launches()
    return {
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else None),
        "kernel_launches": {k: after[k] - before.get(k, 0) for k in after},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m siddhi_tpu_torch.fuzz",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device every engine run uses (default: "
                         "the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=200)
    ap.add_argument("--start-case", type=int, default=0,
                    help="resume the corpus from this case index (case "
                         "i is a pure function of (seed, i))")
    ap.add_argument("--events", type=int, default=60,
                    help="events per generated case")
    ap.add_argument("--max-combos", type=int, default=12,
                    help="per-case matrix cap (coverage-preserving "
                         "sample; dropped combos are reported)")
    ap.add_argument("--time-budget", type=float, default=None,
                    help="stop cleanly after this many seconds")
    ap.add_argument("--shrink-runs", type=int, default=120,
                    help="engine-run budget per divergence shrink")
    ap.add_argument("--report", default=None,
                    help="write the JSON report here")
    ap.add_argument("--fixture-dir", default=None,
                    help="where shrunk repros land (default "
                         "tests/fixtures/fuzz under the working "
                         "directory, or a temp dir in planted mode)")
    ap.add_argument("--max-queries", type=int, default=4,
                    help="max queries per generated case")
    ap.add_argument("--quick", action="store_true",
                    help="fast seeded subset (3 cases, 4 combos each)")
    ap.add_argument("--plant", action="store_true",
                    help="planted-divergence self-test mode")
    ap.add_argument("--autopilot", action="store_true",
                    help="autopilot axis: run every combo with the "
                         "closed-loop controller ON at an aggressive "
                         "cadence — live actuations mid-feed must stay "
                         "bit-identical to the all-legacy baseline")
    ap.add_argument("--cluster", action="store_true",
                    help="cluster axis: run each case's app PINNED on a "
                         "live 2-worker cluster fabric on --device and "
                         "diff the ordered egress against the in-process "
                         "all-legacy baseline (exact, order-sensitive)")
    args = ap.parse_args(argv)

    if args.cluster:
        return _cluster_main(args)

    if args.quick:
        args.cases = min(args.cases, 3)
        args.events = min(args.events, 30)
        args.max_combos = min(args.max_combos, 4)
        args.max_queries = min(args.max_queries, 2)
        args.shrink_runs = min(args.shrink_runs, 40)

    from siddhi_tpu_torch.fuzz.generator import CaseGenerator
    from siddhi_tpu_torch.fuzz.runner import plant_enabled, run_case
    from siddhi_tpu_torch.fuzz.shrink import shrink_case, write_fixture

    plant = args.plant or plant_enabled()
    fixture_dir = args.fixture_dir or (
        tempfile.mkdtemp(prefix="fuzz_planted_") if plant
        else os.path.join("tests", "fixtures", "fuzz"))

    gen = CaseGenerator(seed=args.seed, events_per_case=args.events,
                        max_queries=args.max_queries)
    before = _kernel_launches()
    t0 = time.time()
    report = {
        "seed": args.seed,
        "cases_requested": args.cases,
        "cases_run": 0,
        "combos_run_total": 0,
        "strategy_pairs_diffed": 0,
        "combos_dropped_by_cap": 0,
        "planted_mode": plant,
        "autopilot_axis": args.autopilot,
        "budget_exhausted": False,
        "divergences": [],
        "census_findings": [],
        "logged_errors": [],
        "declared_gaps": [],
        "eligibility_census": {},
        "fixtures": [],
    }
    census_agg = {}

    def fold_census(census):
        for _q, rows in (census or {}).items():
            for surface, code, _detail in rows:
                cval = getattr(code, "value", str(code))
                census_agg.setdefault(surface, {})
                census_agg[surface][cval] = \
                    census_agg[surface].get(cval, 0) + 1

    report["start_case"] = args.start_case
    report["last_case"] = args.start_case - 1
    shrunk_ok = False
    for i in range(args.start_case, args.cases):
        if args.time_budget is not None \
                and time.time() - t0 > args.time_budget:
            report["budget_exhausted"] = True
            print(f"[fuzz] time budget hit after case {i - 1}", flush=True)
            break
        case = gen.case(i)
        deadline = None
        if args.time_budget is not None:
            deadline = time.monotonic() + max(
                5.0, args.time_budget - (time.time() - t0))
        try:
            res = run_case(case, max_combos=args.max_combos,
                           max_shards=N_SHARDS, plant=plant,
                           stop_on_divergence=plant, deadline=deadline,
                           autopilot=args.autopilot, device=args.device)
        except Exception as e:   # baseline run died: a finding, not an abort
            msg = (f"case {i}: baseline run failed: "
                   f"{type(e).__name__}: {e}")
            print(f"[fuzz] {msg}", flush=True)
            report["case_errors"] = report.get("case_errors", []) + [msg]
            report["cases_run"] += 1
            report["last_case"] = i
            continue
        report["cases_run"] += 1
        report["last_case"] = i
        report["combos_run_total"] += len(res.combos_run)
        report["strategy_pairs_diffed"] += res.pairs_diffed
        report["combos_dropped_by_cap"] += res.plan.dropped
        # join surfaces read DISABLED under the legacy baseline: when a
        # device-mode census exists, its join rows REPLACE the
        # baseline's (never both — one classification per query per
        # surface in the aggregate)
        join_surfaces = ("join_engine", "join_pipeline")
        if res.census_device:
            fold_census({q: [r for r in rows
                             if r[0] not in join_surfaces]
                         for q, rows in res.census.items()})
            fold_census({q: [r for r in rows if r[0] in join_surfaces]
                         for q, rows in res.census_device.items()})
        else:
            fold_census(res.census)
        for f in res.census_findings:
            if f not in report["census_findings"]:
                report["census_findings"].append(f)
        for g in res.declared_gaps:
            report["declared_gaps"].append(f"case {i}: {g}")
        for line in res.logged_errors:
            report["logged_errors"].append(f"case {i}: {line}")
            print(f"[fuzz] case {i} LOGGED ERRORS under {line}", flush=True)
        for combo, diff in res.divergences:
            print(f"[fuzz] case {i} DIVERGED under {combo.label()}: "
                  f"{diff.summary()}", flush=True)
            if diff.kind != "rows":
                # a crashed variant has nothing the row-differ can
                # re-confirm — record it unshrunk instead of burning
                # the shrink budget on candidates that can never pass
                report["divergences"].append({
                    "case": i, "combo": combo.label(),
                    "diff": diff.summary(), "shrunk": False,
                })
                continue
            s = shrink_case(case, combo, diff, plant=plant,
                            max_runs=args.shrink_runs, device=args.device)
            path = write_fixture(s.case, s.combo, s.diff, fixture_dir)
            report["fixtures"].append(path)
            report["divergences"].append({
                "case": i, "combo": combo.label(),
                "diff": diff.summary(),
                "shrunk_combo": s.combo.label(),
                "shrunk_clauses": s.case.clause_count(),
                "shrunk_events": len(s.case.events),
                "shrink_steps": s.steps,
                "fixture": path,
            })
            print(f"[fuzz]   shrunk to {s.case.clause_count()} clauses / "
                  f"{len(s.case.events)} events under {s.combo.label()} "
                  f"-> {path}", flush=True)
            if s.case.clause_count() <= 3:
                shrunk_ok = True
        if plant and report["divergences"]:
            break   # self-test proved the point; no need to keep going
        if (i + 1) % 10 == 0:
            print(f"[fuzz] {i + 1}/{args.cases} cases, "
                  f"{report['strategy_pairs_diffed']} pairs diffed, "
                  f"{len(report['divergences'])} divergences, "
                  f"{time.time() - t0:.0f}s", flush=True)

    report["eligibility_census"] = census_agg
    report["elapsed_s"] = round(time.time() - t0, 1)
    report.update(_device_fields(args.device, before))
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
    print(f"[fuzz] {report['cases_run']} cases, "
          f"{report['combos_run_total']} combo runs, "
          f"{report['strategy_pairs_diffed']} pairs diffed, "
          f"{len(report['divergences'])} divergences, "
          f"{len(report['census_findings'])} census findings, "
          f"{len(report['logged_errors'])} runs with logged errors, "
          f"{len(report['declared_gaps'])} declared gaps "
          f"in {report['elapsed_s']}s on {report['device']}", flush=True)
    for f in report["census_findings"][:10]:
        print(f"[fuzz] census: {f}", flush=True)

    if plant:
        caught = bool(report["divergences"])
        if caught and shrunk_ok:
            print("[fuzz] PASS planted divergence caught and shrunk to "
                  "<= 3 clauses", flush=True)
            return 0
        print(f"[fuzz] FAIL planted divergence "
              f"{'not caught' if not caught else 'not minimal'}",
              flush=True)
        return 1
    clean = not report["divergences"] and not report["census_findings"] \
        and not report["logged_errors"] and not report.get("case_errors")
    print(f"[fuzz] {'PASS' if clean else 'FAIL'} cross-strategy "
          f"equivalence", flush=True)
    return 0 if clean else 1


def _cluster_main(args) -> int:
    """The --cluster axis: every corpus case deployed PINNED on one
    shared 2-worker fabric on ``--device``, its chunked feed driven
    through the router (global sequencing + wire relay + ordered egress),
    outputs diffed exactly against the in-process all-legacy run of the
    same chunks on the same device. Workers are real processes, so one
    fabric is reused across the whole subset to amortize the spawn."""
    from siddhi_tpu_torch.cluster import ClusterRuntime
    from siddhi_tpu_torch.fuzz.generator import CaseGenerator
    from siddhi_tpu_torch.fuzz.runner import (
        BASELINE, diff_outputs, run_cluster_case, run_combo)

    cases = min(args.cases, 10) if args.quick else min(args.cases, 40)
    events = min(args.events, 40) if args.quick else args.events
    gen = CaseGenerator(seed=args.seed, events_per_case=events,
                        max_queries=args.max_queries)
    before = _kernel_launches()
    t0 = time.time()
    report = {
        "seed": args.seed, "cluster_axis": True, "cases_run": 0,
        "divergences": [], "case_errors": [],
    }
    cluster = ClusterRuntime(n_workers=2, heartbeat_s=0.2,
                             device=args.device)
    try:
        cluster.wait_ready(60)
        for i in range(args.start_case, cases):
            if args.time_budget is not None \
                    and time.time() - t0 > args.time_budget:
                report["budget_exhausted"] = True
                print(f"[fuzz] time budget hit after case {i - 1}",
                      flush=True)
                break
            case = gen.case(i)
            try:
                base, _census, _errs = run_combo(case, BASELINE,
                                                 device=args.device)
                got = run_cluster_case(case, cluster, f"case{i}")
            except Exception as e:   # a crash is a finding, not an abort
                msg = (f"case {i}: cluster run failed: "
                       f"{type(e).__name__}: {e}")
                print(f"[fuzz] {msg}", flush=True)
                report["case_errors"].append(msg)
                report["cases_run"] += 1
                continue
            report["cases_run"] += 1
            diff = diff_outputs(base, got)
            if diff is not None:
                print(f"[fuzz] case {i} DIVERGED on the cluster: "
                      f"{diff.summary()}", flush=True)
                report["divergences"].append(
                    {"case": i, "diff": diff.summary()})
        report["workers"] = {str(k): v for k, v in
                             cluster.worker_stats().items()}
    finally:
        cluster.shutdown()
    report["elapsed_s"] = round(time.time() - t0, 1)
    report.update(_device_fields(args.device, before))
    if args.report:
        with open(args.report, "w") as f:
            f.write(json.dumps(report, indent=2, sort_keys=True) + "\n")
    clean = not report["divergences"] and not report["case_errors"]
    print(f"[fuzz] cluster axis: {report['cases_run']} cases, "
          f"{len(report['divergences'])} divergences, "
          f"{len(report['case_errors'])} errors in "
          f"{report['elapsed_s']}s on {report['device']} — "
          f"{'PASS' if clean else 'FAIL'}", flush=True)
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main())
