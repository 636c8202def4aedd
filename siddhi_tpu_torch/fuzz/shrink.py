"""Divergence shrinking: reduce a failing case to a minimal repro.

Counterpart of ``siddhi_tpu/fuzz/shrink.py``: the same passes in the same
order, every engine run on the ``device`` the caller names (None: the
card). Its fixtures use the reference's format, so one loader reads both
packages' fixtures.

Given a case + the strategy combo that diverged from baseline, greedily
reduce while the divergence persists, in cost order:

1. **drop whole queries** (the unrelated members of a generated app);
2. **drop clauses** of the surviving queries — filter, having,
   group-by, join residual, window — and halve window parameters,
   always by clearing a FIELD of the typed spec and re-rendering, so
   every candidate is well-formed by construction;
3. **shrink the input feed** ddmin-style (drop halves, then quarters,
   ...), keeping cross-stream interleaving order;
4. **lower the strategy knobs** (shards 4 -> 2 -> 1, join partitions
   8 -> 1, depth 4 -> 2, pool 2 -> 0, fusion off, join engine legacy) so
   the repro names the SMALLEST configuration that still diverges.

Every candidate is verified by actually re-running baseline + variant
(``runner.run_combo``) — a reduction that makes the divergence vanish
(or turns it into a different failure kind) is reverted. The run budget
bounds total engine runs, so shrinking a pathological case degrades to
"less minimal", never to "hangs".

The minimal repro is written as a self-contained JSON fixture under
``tests/fixtures/fuzz/`` (the known-bad-set pattern): app text +
typed spec + feed + combo + the observed first divergence. Promote one
by committing it: ``tests/test_fuzz.py`` and ``tests/test_torch_fuzz.py``
load every committed fixture, re-render it and check its stored
divergence record.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, field
from typing import List, Optional

from siddhi_tpu_torch.fuzz.runner import (
    BASELINE,
    DiffReport,
    StrategyCombo,
    diff_outputs,
    run_combo,
)
from siddhi_tpu_torch.fuzz.schema import CaseSpec


@dataclass
class ShrinkResult:
    case: CaseSpec
    combo: StrategyCombo
    diff: DiffReport
    runs_used: int = 0
    steps: List[str] = field(default_factory=list)
    fixture_path: Optional[str] = None


class _Budget:
    def __init__(self, max_runs: int):
        self.left = max_runs
        self.used = 0

    def take(self, n: int = 2) -> bool:
        if self.left < n:
            return False
        self.left -= n
        self.used += n
        return True


def _check(case: CaseSpec, combo: StrategyCombo, plant: Optional[bool],
           budget: _Budget, device=None) -> Optional[DiffReport]:
    """Does this candidate still diverge (rows-kind)? None = no/over
    budget/candidate failed to run at all."""
    if not budget.take():
        return None
    try:
        base, _c, _e = run_combo(case, BASELINE, plant=bool(plant),
                                 device=device)
        out, _c2, _e2 = run_combo(case, combo, plant=bool(plant),
                                  device=device)
    except Exception:
        return None                  # candidate broke the app: revert
    d = diff_outputs(base, out)
    if d is not None and d.kind == "rows":
        return d
    return None


def _consumed_streams(case: CaseSpec) -> set:
    used = set()
    for q in case.queries:
        if q.kind == "single":
            used.add(q.from_stream)
        elif q.kind == "join":
            used.add(q.join.left_stream)
            used.add(q.join.right_stream)
        elif q.kind == "pattern":
            used.add(q.pattern.first_stream)
            used.add(q.pattern.second_stream)
    return used


def _with_queries(case: CaseSpec, queries) -> CaseSpec:
    return CaseSpec(seed=case.seed, streams=case.streams,
                    queries=queries, events=case.events, notes=case.notes)


def _with_events(case: CaseSpec, events) -> CaseSpec:
    return CaseSpec(seed=case.seed, streams=case.streams,
                    queries=case.queries, events=events, notes=case.notes)


def shrink_case(case: CaseSpec, combo: StrategyCombo,
                diff: DiffReport, plant: Optional[bool] = None,
                max_runs: int = 120, device=None) -> ShrinkResult:
    """Greedy fixpoint reduction; see module docstring for the passes.
    Every candidate runs on ``device`` (None: the card)."""
    budget = _Budget(max_runs)
    res = ShrinkResult(case=case, combo=combo, diff=diff)

    # -- pass 1: drop whole queries ---------------------------------
    changed = True
    while changed and len(res.case.queries) > 1:
        changed = False
        for i in range(len(res.case.queries) - 1, -1, -1):
            cand_queries = res.case.queries[:i] + res.case.queries[i + 1:]
            dropped = res.case.queries[i]
            cand = _with_queries(res.case, cand_queries)
            # keep producers of still-consumed derived streams
            if dropped.insert_into in _consumed_streams(cand):
                continue
            d = _check(cand, res.combo, plant, budget, device)
            if d is not None:
                res.case, res.diff, changed = cand, d, True
                res.steps.append(f"dropped query {dropped.name}")

    # -- pass 1.5: drop streams no surviving query reads ------------
    used = _consumed_streams(res.case)
    keep_streams = [s for s in res.case.streams if s.name in used]
    if len(keep_streams) < len(res.case.streams):
        cand = CaseSpec(
            seed=res.case.seed, streams=keep_streams,
            queries=res.case.queries,
            events=[e for e in res.case.events
                    if e[0] in {s.name for s in keep_streams}],
            notes=res.case.notes)
        n_dropped = len(res.case.streams) - len(keep_streams)
        d = _check(cand, res.combo, plant, budget, device)
        if d is not None:
            res.case, res.diff = cand, d
            res.steps.append(f"dropped {n_dropped} unused streams")

    # -- pass 2: drop clauses / shrink windows ----------------------
    changed = True
    while changed:
        changed = False
        for qi, q in enumerate(res.case.queries):
            for cand_q, step in _clause_candidates(q):
                cand = _with_queries(
                    res.case, res.case.queries[:qi] + [cand_q]
                    + res.case.queries[qi + 1:])
                d = _check(cand, res.combo, plant, budget, device)
                if d is not None:
                    res.case, res.diff, changed = cand, d, True
                    res.steps.append(f"{q.name}: {step}")
                    break
            if changed:
                break

    # -- pass 3: ddmin the feed -------------------------------------
    n_chunks = 2
    while n_chunks <= len(res.case.events):
        events = res.case.events
        size = max(1, len(events) // n_chunks)
        removed_any = False
        start = 0
        while start < len(res.case.events):
            events = res.case.events
            cand_events = events[:start] + events[start + size:]
            if not cand_events:
                break
            d = _check(_with_events(res.case, cand_events),
                       res.combo, plant, budget, device)
            if d is not None:
                res.case = _with_events(res.case, cand_events)
                res.diff = d
                res.steps.append(
                    f"removed events [{start}:{start + size}]")
                removed_any = True
            else:
                start += size
        if not removed_any:
            if size <= 1:
                break
            n_chunks *= 2
        if budget.left < 2:
            break

    # -- pass 4: lower the strategy knobs ---------------------------
    # the case is frozen from here on: run the baseline ONCE and diff
    # each lowered-knob candidate against the cached result (one engine
    # run per candidate instead of two)
    base_cached = None
    if budget.take(1):
        try:
            base_cached, _c, _e = run_combo(res.case, BASELINE,
                                            plant=bool(plant), device=device)
        except Exception:
            base_cached = None
    if base_cached is not None:
        # fixpoint: re-derive candidates from the CURRENT combo after
        # each acceptance — a later candidate built from the original
        # combo would silently revert earlier accepted lowerings
        progressed = True
        while progressed:
            progressed = False
            for lowered, step in _combo_candidates(res.combo):
                if not budget.take(1):
                    break
                try:
                    out, _c, _e = run_combo(res.case, lowered,
                                            plant=bool(plant), device=device)
                except Exception:
                    continue
                d = diff_outputs(base_cached, out)
                if d is not None and d.kind == "rows":
                    res.combo, res.diff = lowered, d
                    res.steps.append(f"combo: {step}")
                    progressed = True
                    break

    res.runs_used = budget.used
    return res


def _clause_candidates(q):
    """Single-clause reductions of one QuerySpec (typed: clear a field,
    never edit text). Every mutated candidate DROPS the generator's
    eligibility expectations — they described the original shape, and a
    stale expect dict in a committed fixture would make its replay
    report phantom census fallbacks."""
    import copy

    out = []

    def variant(step, **changes):
        c = copy.deepcopy(q)
        for k, v in changes.items():
            setattr(c, k, v)
        c.expect = {}
        out.append((c, step))

    if q.filter:
        variant("dropped filter", filter=None)
    if q.having:
        variant("dropped having", having=None)
    if q.group_by and not any("(" in e for e, _a in q.select_items):
        variant("dropped group by", group_by=None)
    if q.window and q.window[1] > 2:
        c = copy.deepcopy(q)
        c.window = [c.window[0], max(2, c.window[1] // 2)]
        c.expect = {}
        out.append((c, f"window param -> {c.window[1]}"))
    if q.join is not None:
        if q.join.residual:
            c = copy.deepcopy(q)
            c.join.residual = None
            c.expect = {}
            out.append((c, "dropped join residual"))
        for side in ("left_window", "right_window"):
            w = getattr(q.join, side)
            if w and w[1] > 2:
                c = copy.deepcopy(q)
                setattr(c.join, side, [w[0], max(2, w[1] // 2)])
                c.expect = {}
                out.append((c, f"{side} param -> {max(2, w[1] // 2)}"))
    if len(q.select_items) > 1:
        c = copy.deepcopy(q)
        c.select_items = c.select_items[:1]
        c.expect = {}
        out.append((c, "select -> first item"))
    return out


def _combo_candidates(combo: StrategyCombo):
    if combo.shards > 1:
        yield (StrategyCombo(**{**asdict(combo),
                                "shards": combo.shards // 2}),
               f"shards -> {combo.shards // 2}")
    if combo.join_partitions > 1:
        yield (StrategyCombo(**{**asdict(combo), "join_partitions": 1}),
               "join_partitions -> 1")
    if combo.depth > 2:
        yield (StrategyCombo(**{**asdict(combo), "depth": 2}),
               "depth -> 2")
    if combo.pool > 0:
        yield (StrategyCombo(**{**asdict(combo), "pool": 0}), "pool -> 0")
    if combo.fuse:
        yield (StrategyCombo(**{**asdict(combo), "fuse": False}),
               "fuse -> off")
    if combo.join_engine == "device":
        yield (StrategyCombo(**{**asdict(combo), "join_engine": "legacy",
                                "join_partitions": 1}),
               "join_engine -> legacy")


# ------------------------------------------------------------- fixtures

def fixture_dict(case: CaseSpec, combo: StrategyCombo,
                 diff: DiffReport) -> dict:
    return {
        "format": "siddhi-tpu-fuzz-divergence-v1",
        "app": case.app_text(),
        "case": asdict(case),
        "combo": asdict(combo),
        "baseline": asdict(BASELINE),
        "diff": asdict(diff),
        "clause_count": case.clause_count(),
    }


def write_fixture(case: CaseSpec, combo: StrategyCombo, diff: DiffReport,
                  directory: str) -> str:
    """Write the shrunk repro as a self-contained JSON fixture; the
    filename is content-addressed so re-finding the same bug is
    idempotent."""
    payload = fixture_dict(case, combo, diff)
    blob = json.dumps(payload, indent=2, sort_keys=True)
    digest = hashlib.sha1(
        (case.app_text() + combo.label()).encode()).hexdigest()[:10]
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(
        directory, f"divergence_seed{case.seed}_{digest}.json")
    with open(path, "w") as f:
        f.write(blob + "\n")
    return path
