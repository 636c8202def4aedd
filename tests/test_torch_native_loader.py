"""The port's native ingest loader (``siddhi_tpu_torch/native/``
``CsvLoader``, ``JsonlLoader`` over ``csv_loader.cpp``) against the
reference's (``siddhi_tpu/native/``).

- Every case of ``tests/test_native_loader.py`` through both packages on
  the same bytes: columns (dtypes too), null masks and dictionary ids
  equal exactly, and the end-to-end rows through ``send_columns`` equal.
- A seeded fuzz of CSV and JSONL buffers (quotes, escapes, CRLF, empty,
  missing and extra fields, non-ASCII, bytes that are not UTF-8,
  malformed lines), several parses a loader against dictionaries that
  already hold strings: equal columns and ids, or both raise. One
  divergence, asserted as such: a buffer whose string fields are all
  null before the loader has seen any string makes the reference raise
  ``IndexError`` (it indexes an empty id map); the port returns the
  column null-masked, every id ``NULL_ID``.
- The global flagship on the CPU fed from CSV and from JSONL bytes gives
  the rows of the same feed sent as columns.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
from torch_helpers import (  # release_jax_programs: an autouse fixture
    make_collector, release_jax_programs)  # noqa: F401

PKGS = ("jax", "torch")


def _pkg(name):
    import functools

    if name == "jax":
        import siddhi_tpu as P
        from siddhi_tpu import native
        from siddhi_tpu.core.event import StringDictionary
        from siddhi_tpu.query_api import definitions

        manager = P.SiddhiManager
    else:
        import siddhi_tpu_torch as P
        from siddhi_tpu_torch import native
        from siddhi_tpu_torch.core.event import StringDictionary
        from siddhi_tpu_torch.query_api import definitions

        manager = functools.partial(P.SiddhiManager, device="cpu")
    return types.SimpleNamespace(
        SiddhiManager=manager, StreamCallback=P.StreamCallback,
        CsvLoader=native.CsvLoader, JsonlLoader=native.JsonlLoader,
        StringDictionary=StringDictionary, Attribute=definitions.Attribute,
        AttrType=definitions.AttrType, StreamDefinition=definitions.StreamDefinition)


def _assert_cols_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        # NaN (a "nan" field) equals NaN: the bits are compared, not IEEE ==
        assert np.array_equal(got[k], want[k], equal_nan=got[k].dtype.kind == "f"), \
            (k, got[k], want[k])


def _definition(P, spec):
    return P.StreamDefinition("S", [P.Attribute(n, getattr(P.AttrType, t))
                                    for n, t in spec])


# -------------------------------------------- tests/test_native_loader.py

def _app_parse(pkg, app, data, loader="CsvLoader"):
    P = _pkg(pkg)
    m = P.SiddhiManager()
    rt = m.create_siddhi_app_runtime(app)
    dic = rt.app_context.string_dictionary
    cols, n = getattr(P, loader)(rt.stream_definitions["S"], dic).parse(data)
    m.shutdown()
    return cols, n, list(dic._to_str)


@pytest.mark.parametrize("app,data", [
    # test_csv_loader_parses_typed_columns
    ("define stream S (sym string, price double, volume long, ok bool);"
     "from S select sym insert into Out;",
     b"IBM,55.5,100,true\nWSO2,7.25,42,false\n"),
    # test_csv_loader_nulls_and_dictionary_reuse
    ("define stream S (sym string, price double);"
     "from S select sym insert into Out;", b"A,1.5\n,\nA,2.5\n"),
], ids=["typed_columns", "nulls_and_dictionary_reuse"])
def test_csv_cases_match_the_reference(app, data):
    (rc, rn, rs), (pc, pn, ps) = (_app_parse(p, app, data) for p in PKGS)
    assert pn == rn and ps == rs
    _assert_cols_equal(pc, rc)


def _rows_through_send_columns(pkg, data, loader):
    P = _pkg(pkg)
    m = P.SiddhiManager()
    rt = m.create_siddhi_app_runtime("""
        define stream S (sym string, price double);
        from S[price > 10.0] select sym, price insert into Out;
    """)
    c = make_collector(P.StreamCallback)
    rt.add_callback("Out", c)
    cols, n = getattr(P, loader)(rt.stream_definitions["S"],
                                 rt.app_context.string_dictionary).parse(data)
    rt.get_input_handler("S").send_columns(
        cols, timestamps=np.arange(n, dtype=np.int64))
    m.shutdown()
    return [(ts, row) for ts, row, _exp in c.rows]


@pytest.mark.parametrize("loader,data,want", [
    # test_csv_loader_end_to_end
    ("CsvLoader", b"IBM,55.5\nWSO2,7.25\nGOOG,20.0\n",
     [(0, ("IBM", 55.5)), (2, ("GOOG", 20.0))]),
    # test_jsonl_loader_end_to_end
    ("JsonlLoader", b'{"sym": "A", "price": 50.0}\n{"sym": "B", "price": 5.0}\n',
     [(0, ("A", 50.0))]),
])
def test_end_to_end_matches_the_reference(loader, data, want):
    ref = _rows_through_send_columns("jax", data, loader)
    port = _rows_through_send_columns("torch", data, loader)
    assert port == ref == want


def _standalone(pkg, spec, data):
    P = _pkg(pkg)
    dic = P.StringDictionary()
    cols, n = P.JsonlLoader(_definition(P, spec), dic).parse(data)
    return cols, n, list(dic._to_str)


@pytest.mark.parametrize("spec,data", [
    # test_jsonl_loader_parses_typed_columns
    ((("sym", "STRING"), ("price", "DOUBLE"), ("vol", "LONG"), ("ok", "BOOL")),
     b'{"sym": "IBM", "price": 42.5, "vol": 100, "ok": true}\n'
     b'{"price": 1.25, "sym": "W\\"X", "vol": null, "ok": false}\n'
     b'{"sym": "IBM", "extra": 9, "price": 7, "vol": 3, "ok": true}\n'),
    # test_jsonl_loader_unicode_escapes
    ((("sym", "STRING"),),
     "".join(json.dumps({"sym": v}) + "\n"
             for v in ["café", "日本", "emoji 🎉", 'quote"inside']).encode()),
], ids=["typed_columns", "unicode_escapes"])
def test_jsonl_cases_match_the_reference(spec, data):
    (rc, rn, rs), (pc, pn, ps) = (_standalone(p, spec, data) for p in PKGS)
    assert pn == rn and ps == rs
    _assert_cols_equal(pc, rc)
    if len(spec) == 1:
        assert ps == ["café", "日本", "emoji 🎉", 'quote"inside']
    else:
        assert ps == ["IBM", 'W"X'] and list(pc["vol?"]) == [False, True, False]


# ------------------------------------------------------------------- fuzz

SPEC = (("sym", "STRING"), ("price", "DOUBLE"), ("vol", "LONG"), ("ok", "BOOL"),
        ("tag", "STRING"), ("n", "INT"), ("f", "FLOAT"))
_WORDS = ["IBM", "W\"X", "a\\b", "café", "日本", "🎉", "x y", "", "q'", "S1",
          "S2", "tab\there", "ünï", "a/b"]
_NUMS = ["0", "-7", "42", "3.5", "-0.25", "1e3", "12abc", "", "nan", " 5",
         "9223372036854775807"]
_BOOLS = ["true", "false", "TRUE", "1", "0", "t", "yes", ""]


def _csv_buffer(rng) -> bytes:
    lines = []
    for _ in range(int(rng.integers(0, 12))):
        fields = [str(rng.choice(_WORDS)), str(rng.choice(_NUMS)),
                  str(rng.choice(_NUMS)), str(rng.choice(_BOOLS)),
                  str(rng.choice(_WORDS)), str(rng.choice(_NUMS)),
                  str(rng.choice(_NUMS))]
        cut = int(rng.integers(0, 9))
        if cut < len(fields):           # missing fields, or an extra one
            fields = fields[:cut] if rng.random() < 0.5 else fields + ["extra"]
        if fields and rng.random() < 0.1:
            fields[0] = '"quoted, comma"'
        lines.append(",".join(fields))
    end = "\r\n" if rng.random() < 0.3 else "\n"
    data = end.join(lines).encode("utf-8")
    if rng.random() < 0.5:
        data += end.encode()
    if rng.random() < 0.05:
        data += b"\xff\xfe,1\n"         # not UTF-8
    return data


_JSON_STRS = ['"IBM"', '"W\\"X"', '"a\\\\b"', '"a\\/b"', '"l\\nf"', '"t\\tr\\r"',
              '"caf\\u00e9"', '"\\ud83c\\udf89"', '"日本"', '""', '"q\'"', "null",
              '"S1"', '"\\u12G4"']


def _jsonl_buffer(rng) -> bytes:
    lines = []
    for _ in range(int(rng.integers(0, 10))):
        vals = {"sym": str(rng.choice(_JSON_STRS)),
                "price": str(rng.choice(["1.5", "-2", "null", "7", "1e2"])),
                "vol": str(rng.choice(["3", "null", "-11", "0"])),
                "ok": str(rng.choice(["true", "false", "null"])),
                "tag": str(rng.choice(_JSON_STRS)),
                "n": str(rng.choice(["1", "2", "null"])),
                "f": str(rng.choice(["0.5", "null", "3"])),
                "junk": str(rng.choice(['"x"', "9", "null"]))}
        keys = list(vals)
        rng.shuffle(keys)
        keys = keys[:int(rng.integers(0, len(keys) + 1))]
        sep = str(rng.choice([", ", ",", " , "]))
        body = sep.join(f'"{k}": {vals[k]}' for k in keys)
        line = "{" + body + "}"
        if rng.random() < 0.04:
            line = line[:-1]            # malformed: no closing brace
        lines.append(line)
    end = "\r\n" if rng.random() < 0.3 else "\n"
    return (end.join(lines) + (end if rng.random() < 0.5 else "")).encode("utf-8")


def _outcome(loader, data):
    try:
        return "ok", loader.parse(data)
    except Exception as e:   # compared across packages below
        return type(e), None


@pytest.mark.parametrize("kind", ["CsvLoader", "JsonlLoader"])
@pytest.mark.parametrize("seed", range(4))
def test_fuzz_both_parsers_agree(kind, seed):
    rng = np.random.default_rng(1000 * seed + (kind == "JsonlLoader"))
    make = _csv_buffer if kind == "CsvLoader" else _jsonl_buffer
    seeded = ["IBM", "S2", "zeta"] if seed % 2 else []

    def fresh():
        out = {}
        for pkg in PKGS:
            P = _pkg(pkg)
            dic = P.StringDictionary()
            for s in seeded:
                dic.encode(s)
            out[pkg] = (getattr(P, kind)(_definition(P, SPEC), dic), dic)
        return out

    loaders = fresh()
    checked = 0
    for _ in range(30):
        data = make(rng)
        (rk, rv), (pk, pv) = (_outcome(loaders[p][0], data) for p in PKGS)
        if rk is IndexError and pk == "ok":
            # the one divergence: string fields all null, no string seen
            cols, n = pv
            for name, t in SPEC:
                if t == "STRING":
                    assert cols[name + "?"].all() and (cols[name] == -1).all()
            assert len(loaders["torch"][1]) == len(seeded)
            continue
        assert pk == rk, (data, rk, pk)
        if rk == "ok":
            (rc, rn), (pc, pn) = rv, pv
            assert pn == rn, data
            _assert_cols_equal(pc, rc)
            checked += 1
        assert loaders["torch"][1]._to_str == loaders["jax"][1]._to_str, data
        if rk != "ok":
            # a string that is not UTF-8 stays in both native dictionaries
            # and fails every later sync alike: go on with fresh loaders
            loaders = fresh()
    assert checked >= 10


def test_malformed_buffers_raise_value_error():
    for pkg in PKGS:
        P = _pkg(pkg)
        loader = P.JsonlLoader(_definition(P, SPEC), P.StringDictionary())
        for bad in (b'[1, 2]\n', b'{"sym": "x"\n', b'{"sym": "\\u12G4"}\n',
                    b'{sym: 1}\n', b'{"sym" 1}\n'):
            with pytest.raises(ValueError, match="JsonlLoader: parse failed"):
                loader.parse(bad)


def test_long_strings_round_trip():
    """A string longer than the reference's 64 KiB read-back buffer: the
    port exports every new string whole."""
    P = _pkg("torch")
    dic = P.StringDictionary()
    long = "x" * 70000 + "é"
    cols, n = P.CsvLoader(_definition(P, (("sym", "STRING"),)), dic).parse(
        (long + "\nb\n" + long + "\n").encode())
    assert n == 3 and dic._to_str == [long, "b"]
    assert cols["sym"].tolist() == [0, 1, 0]


# -------------------------------------------------------- the flagship

GLOBAL_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length(64)
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol
insert into OutStream;
"""


def _flagship_feed():
    rng = np.random.default_rng(7)
    syms = np.array([f"S{i}" for i in range(50)], dtype=object)
    feed = []
    for b in range(3):
        ids = rng.integers(0, 50, 256)
        feed.append(({"symbol": syms[ids],
                      "price": (rng.random(256) * 100).astype(np.float32),
                      "volume": rng.integers(1, 1000, 256)},
                     np.arange(b * 256, (b + 1) * 256, dtype=np.int64)))
    return feed


def _as_bytes(cols, kind) -> bytes:
    # float32 prices as the float64 repr of their value: parsing it back
    # and casting to float32 is exact
    rows = zip(cols["symbol"].tolist(), cols["price"].astype(np.float64).tolist(),
               cols["volume"].tolist())
    if kind == "CsvLoader":
        return "".join(f"{s},{p!r},{v}\n" for s, p, v in rows).encode()
    return "".join(json.dumps({"volume": v, "symbol": s, "price": p}) + "\n"
                   for s, p, v in rows).encode()


def _flagship_rows(feed, kind=None):
    P = _pkg("torch")
    m = P.SiddhiManager()
    rt = m.create_siddhi_app_runtime(GLOBAL_APP)
    c = make_collector(P.StreamCallback)
    rt.add_callback("OutStream", c)
    h = rt.get_input_handler("StockStream")
    loader = (getattr(P, kind)(rt.stream_definitions["StockStream"],
                               rt.app_context.string_dictionary)
              if kind else None)
    for cols, ts in feed:
        if loader is not None:
            cols, n = loader.parse(_as_bytes(cols, kind))
            assert n == len(ts)
        h.send_columns(cols, timestamps=ts)
    strings = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    return c.rows, strings


@pytest.mark.parametrize("kind", ["CsvLoader", "JsonlLoader"])
def test_flagship_fed_from_bytes_equals_columns(kind):
    feed = _flagship_feed()
    want, want_strings = _flagship_rows(feed)
    got, got_strings = _flagship_rows(feed, kind)
    assert len(got) == 3 * 256
    assert got == want
    assert got_strings == want_strings
