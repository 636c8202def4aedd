"""Faults of the port against the reference, each held by a case here:
integer ``/`` and ``%`` by an attribute (a zero divisor, which every
padded batch holds, yields 0 instead of dropping the batch), Java's
saturating float->int/long casts, and NaN rows, which both packages emit
and the comparison helper must take as equal. Every case runs the same
seeded feed through the JAX package and the port."""

import numpy as np
import pytest
from torch_helpers import Run, assert_rows_match, release_jax_programs

DIV_APP = """
define stream S (a int, b int, c long, d long);
@info(name = 'q')
from S select a / b as x, a % b as y, c / d as z, c % d as w
insert into O;
"""


def _div_feed(n, seed):
    """``n`` rows led by (7, 2), (5, 0), (0, 3), the rest seeded with
    divisors in [-3, 3]: zeros, signs of both operands."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-9, 10, n).astype(np.int32)
    b = rng.integers(-3, 4, n).astype(np.int32)
    head = np.array([[7, 2], [5, 0], [0, 3]], np.int32)[:n]
    a[:len(head)], b[:len(head)] = head[:, 0], head[:, 1]
    return {"a": a, "b": b, "c": rng.integers(-50, 50, n).astype(np.int64),
            "d": rng.integers(-3, 4, n).astype(np.int64)}


@pytest.mark.parametrize("n", [1, 5, 16, 64, 100, 128])
def test_integer_div_mod_by_attribute_every_batch_size(n):
    cols = _div_feed(n, seed=n)
    feed = [("cols", cols, np.arange(n, dtype=np.int64))]
    # single sends too: each is a batch of one padded to eight rows
    feed += [("event", 1000 + i, [int(cols["a"][i]), int(cols["b"][i]),
                                  int(cols["c"][i]), int(cols["d"][i])])
             for i in range(min(n, 5))]
    want = Run("jax", DIV_APP, "O", "q").feed("S", feed).close()
    got = Run("torch", DIV_APP, "O", "q").feed("S", feed).close()
    assert len(got) == n + min(n, 5)      # every row emitted
    assert_rows_match(got, want)
    firsts = [d[:2] for _t, d, _e in got[:min(n, 3)]]
    assert firsts == [(3, 1), (0, 0), (0, 0)][:len(firsts)]


CAST_APP = """
define stream S (d double, f float);
@info(name = 'q')
from S select d, cast(d, 'int') as di, cast(f, 'int') as fi,
              cast(d, 'long') as dl, convert(d, 'long') as cl,
              convert(f, 'int') as ci
insert into O;
"""


def test_float_to_int_casts_saturate_as_java():
    vals = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 1e20, -1e20, 2.7,
                     -2.7, 0.0, 2147483647.0, -2147483648.5])
    rng = np.random.default_rng(3)
    vals = np.concatenate([vals, rng.normal(0, 1e10, 20)])
    feed = [("cols", {"d": vals, "f": vals.astype(np.float32)},
             np.arange(len(vals), dtype=np.int64))]
    want = Run("jax", CAST_APP, "O", "q").feed("S", feed).close()
    got = Run("torch", CAST_APP, "O", "q").feed("S", feed).close()
    assert_rows_match(got, want)
    nan_row, inf_row, ninf_row, big_row, _, huge_row = (d for _t, d, _e in got[:6])
    assert nan_row[1:] == (0, 0, 0, 0, 0)
    assert inf_row[1:] == (2**31 - 1, 2**31 - 1, 2**63 - 1, 2**63 - 1, 2**31 - 1)
    assert ninf_row[1:] == (-2**31, -2**31, -2**63, -2**63, -2**31)
    assert big_row[1:] == (2**31 - 1, 2**31 - 1, 3_000_000_000, 3_000_000_000, 2**31 - 1)
    assert huge_row[3:5] == (2**63 - 1, 2**63 - 1)


def test_nan_rows_compare_equal():
    """A NaN output of both packages compares equal under the helper (it
    failed before it compared floats with equal_nan), and a NaN against
    a number still fails."""
    feed = [("cols", {"d": np.array([np.nan, 1.5]),
                      "f": np.array([np.nan, 1.5], np.float32)},
             np.arange(2, dtype=np.int64))]
    want = Run("jax", CAST_APP, "O", "q").feed("S", feed).close()
    got = Run("torch", CAST_APP, "O", "q").feed("S", feed).close()
    assert np.isnan(got[0][1][0]) and np.isnan(want[0][1][0])
    assert_rows_match(got, want)
    bad = [(got[0][0], (0.0,) + got[0][1][1:], got[0][2])] + got[1:]
    with pytest.raises(AssertionError):
        assert_rows_match(bad, want)
