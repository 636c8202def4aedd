"""A run with the timed path broken underneath it comes out not correct:
for each fault a cell can have, the harness's run and check are driven
on the CPU (the look for a card skipped) and the check fails."""

import numpy as np
import pytest

from portbench import harness


def clone(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(v) for v in tree)
    return tree


def state_unchanged(rt, queries):
    """Every step returns the state it was given."""
    for q in queries:
        orig = q._finish_device_batch

        def step(*args, q=q, orig=orig, **kwargs):
            before = clone(q._state)
            out = orig(*args, **kwargs)
            q._state = before
            return out

        q._finish_device_batch = step


def half_batch(rt, queries):
    """The step sees only the first half of each batch's rows."""
    for q in queries:
        orig = q._finish_device_batch

        def step(device_step, cols, *args, orig=orig, **kwargs):
            cols = dict(cols)
            valid = np.array(cols["__valid__"], copy=True)
            valid[valid.shape[0] // 2:] = False
            cols["__valid__"] = valid
            return orig(device_step, cols, *args, **kwargs)

        q._finish_device_batch = step


def altered_answer(rt, queries):
    """One output value of every batch is off by one where it is made."""
    for q in queries:
        orig = q._emit

        def emit(out, orig=orig):
            cols = out.cols
            name = next(k for k in cols if not k.startswith("__") and not k.endswith("?")
                        and np.asarray(cols[k]).dtype.kind in "iu")
            col = np.array(cols[name], copy=True)
            col[np.flatnonzero(np.asarray(cols["__valid__"]))[-1]] += 1
            cols[name] = col
            return orig(out)

        q._emit = emit


@pytest.fixture
def no_exchange(monkeypatch):
    """The exchange between the key shards moves nothing."""
    from siddhi_tpu_torch.parallel import mesh

    def deploy(rt, queries):
        monkeypatch.setattr(mesh, "ring_exchange_cols", lambda bufs, n: list(bufs))

    return deploy


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}


@pytest.mark.parametrize("workload", ["part.uniform", "distinct.uniform"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(tiny_spec, cpu, workload, fault):
    run = harness.run_cell(tiny_spec, workload, 9, 0.3, False, cpu, 0.0,
                           on_deployed=FAULTS[fault])
    checks = harness.judge(tiny_spec, run)
    assert not harness.passed(checks), checks


def test_the_exchange_left_out_is_not_correct(tiny_spec, cpu, no_exchange):
    run = harness.run_cell(tiny_spec, "part.uniform", 9, 0.3, False, cpu, 0.0,
                           on_deployed=no_exchange)
    checks = harness.judge(tiny_spec, run)
    assert not harness.passed(checks), checks


def test_the_sound_run_is_correct(tiny_spec, cpu):
    run = harness.run_cell(tiny_spec, "part.uniform", 9, 0.3, False, cpu, 0.0)
    assert harness.passed(harness.judge(tiny_spec, run))
