"""The string dictionary's native mirror (``native/strdict.cpp``, built at
first use): its bulk encode gives the same ids as the port's plain Python
probe and as the JAX package's ``StringDictionary``, over a seeded column
with new strings mid-batch, Nones, non-str values, a string utf-8 cannot
carry, and a restored id space. A broken source raises with the
compiler's output instead of falling back."""

import numpy as np
import pytest

from siddhi_tpu.core.event import StringDictionary as RefDictionary
from siddhi_tpu_torch import native
from siddhi_tpu_torch.core.event import StringDictionary


def _column(rng, universe, n):
    col = universe[rng.integers(0, len(universe), n)].copy()
    col[rng.random(n) < 0.05] = None
    for i in rng.choice(n, 4, replace=False):
        col[i] = [7, 3.5, True, "\ud800lone"][i % 4]     # non-str / non-utf-8
    return col


def _plain_encode(d, col):
    ids = d.probe_array_plain(col)
    d.resolve_missing(ids, lambda i: col[i])
    return ids


def test_native_plain_and_reference_ids_agree():
    rng = np.random.default_rng(17)
    universe = np.array([f"sym{i}" for i in range(60)], dtype=object)
    native_d, plain_d, ref = StringDictionary(), StringDictionary(), RefDictionary()
    # batch 0 sees a third of the universe; later batches bring new strings
    # in mid-batch, after rows whose strings are already known
    batches = [_column(rng, universe[:20], 500), _column(rng, universe, 500),
               _column(rng, universe[:50], 300)]
    for i, col in enumerate(batches):
        known = native_d.probe_array(col)
        assert np.array_equal(known[known >= 0],
                              plain_d.probe_array_plain(col)[known >= 0]), i
        got = native_d.encode_array(col)
        assert got.dtype == np.int64
        assert np.array_equal(got, _plain_encode(plain_d, col)), i
        assert np.array_equal(got, ref.encode_array(col)), i
        assert native_d._to_str == plain_d._to_str == ref._to_str
    assert (got == StringDictionary.NULL_ID).any()
    # the lone surrogate never reaches the mirror: it probes as a miss and
    # resolves to its id in Python
    lone = np.array(["\ud800lone", "sym1"], dtype=object)
    assert native_d.probe_array(lone)[0] == StringDictionary._MISS
    assert native_d.encode_array(lone)[0] == native_d._to_id["\ud800lone"]

    # a carried id space replaces the mirror's
    carried = list(reversed(native_d._to_str))
    for d in (native_d, plain_d, ref):
        d.restore_strings(carried)
    col = _column(rng, np.concatenate([universe, ["new0", "new1"]]), 400)
    got = native_d.encode_array(col)
    assert np.array_equal(got, _plain_encode(plain_d, col))
    assert np.array_equal(got, ref.encode_array(col))


def test_rank_table_matches_reference():
    d, ref = StringDictionary(), RefDictionary()
    col = np.array(["pear", "apple", "fig", None, "Zed", "apple", "éclair"],
                   dtype=object)
    assert np.array_equal(d.encode_array(col), ref.encode_array(col))
    assert np.array_equal(d.rank_table(), ref.rank_table())
    d.encode("banana")
    ref.encode("banana")
    assert np.array_equal(d.rank_table(), ref.rank_table())


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "strdict.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "STRDICT_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="strdict build failed") as err:
        native.build_strdict()
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))
