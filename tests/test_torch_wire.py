"""The port's wire format (``siddhi_tpu_torch/core/stream/input/wire.py``),
held against the reference's: the edge cases of tests/test_wire_format.py
(round trips, empty and all-null columns, dictionary deltas, gaps and
resets, scopes, truncation and corruption as clean
``SiddhiAppValidationException``s, hello negotiation, control frames,
LRU eviction, a random-schema sweep), frames crossing between the two
packages' encoders and decoders, and wire ingest through an app equal to
columns ingest in both packages."""

import struct

import numpy as np
import pytest
from torch_helpers import (
    assert_rows_match, make_collector, release_jax_programs)

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu.core.stream.input import wire as ref_wire
from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
from siddhi_tpu_torch.core.event import HostBatch, StringDictionary
from siddhi_tpu_torch.core.stream.input.wire import (
    CAP_CONTROL, CAP_DICT_DELTA, CAP_TS, CAPABILITIES, CTRL_CHECKPOINT_CUT,
    CTRL_HEARTBEAT, CTRL_HELLO, CTRL_SEQ_ACK, MAGIC, VERSION,
    DecoderRegistry, WireEncoder, decode_control, decode_frame,
    encode_control, encode_hello, is_control, negotiate_hello)
from siddhi_tpu_torch.query_api.definitions import (
    Attribute, AttrType, StreamDefinition)


def _definition(attrs):
    return StreamDefinition("S", attributes=[
        Attribute(name, t) for name, t in attrs])


DEF3 = _definition([("sym", AttrType.STRING), ("v", AttrType.DOUBLE),
                    ("n", AttrType.LONG)])


def _decode(frame, definition=DEF3, dictionary=None, registry=None):
    # explicit None checks: an EMPTY StringDictionary is falsy (__len__)
    if dictionary is None:
        dictionary = StringDictionary()
    if registry is None:
        registry = DecoderRegistry()
    return decode_frame(frame, definition, dictionary, registry)


def _strings_of(data, dictionary, name="sym"):
    return [dictionary.decode(int(i)) if i >= 0 else None
            for i in data[name]]


# ------------------------------------------------------------ round trips


def test_round_trip_basic():
    enc = WireEncoder()
    syms = np.array(["a", "b", None, "a", "Grüße-☃"], dtype=object)
    v = np.array([1.5, -2.0, 0.0, 3.25, 1e9])
    n = np.arange(5, dtype=np.int64)
    ts = np.array([10, 20, 30, 40, 50], dtype=np.int64)
    d = StringDictionary()
    data, wts = _decode(enc.encode({"sym": syms, "v": v, "n": n},
                                   timestamps=ts), dictionary=d)
    assert _strings_of(data, d) == ["a", "b", None, "a", "Grüße-☃"]
    assert np.array_equal(np.asarray(data["v"]), v)
    assert np.array_equal(np.asarray(data["n"]), n)
    assert np.array_equal(np.asarray(wts), ts)


def test_round_trip_feeds_from_columns_bit_identically():
    """The wire path must land EXACTLY what direct send_columns lands:
    same HostBatch columns, pre-encoded ids included."""
    enc = WireEncoder()
    syms = np.array(["x", "y", None, "x"], dtype=object)
    v = np.array([1.0, 2.0, 3.0, 4.0])
    n = np.array([1, 2, 3, 4], dtype=np.int64)
    ts = np.arange(4, dtype=np.int64)
    d1, d2 = StringDictionary(), StringDictionary()
    direct = HostBatch.from_columns(
        {"sym": syms, "v": v, "n": n}, DEF3, d1, timestamps=ts)
    data, wts = _decode(enc.encode({"sym": syms, "v": v, "n": n},
                                   timestamps=ts), dictionary=d2)
    wired = HostBatch.from_columns(data, DEF3, d2, timestamps=wts)
    assert d1._to_str == d2._to_str
    for k in direct.cols:
        assert np.array_equal(direct.cols[k], wired.cols[k]), k


def test_empty_batch():
    enc = WireEncoder()
    frame = enc.encode({"sym": np.array([], dtype=object),
                        "v": np.array([], np.float64),
                        "n": np.array([], np.int64)},
                       timestamps=np.array([], np.int64))
    data, wts = _decode(frame)
    assert len(data["sym"]) == 0 and len(wts) == 0


def test_all_null_string_column():
    enc = WireEncoder()
    d = StringDictionary()
    data, _ = _decode(enc.encode(
        {"sym": np.array([None, None, None], dtype=object),
         "v": np.zeros(3), "n": np.zeros(3, np.int64)}), dictionary=d)
    assert _strings_of(data, d) == [None, None, None]
    assert len(d) == 0      # nothing inserted for an all-null column


def test_explicit_null_masks_ride():
    enc = WireEncoder()
    frame = enc.encode({"sym": np.array(["a", "b"], dtype=object),
                        "v": np.array([1.0, 2.0]),
                        "v?": np.array([False, True]),
                        "n": np.array([7, 8], np.int64)})
    data, _ = _decode(frame)
    assert np.array_equal(np.asarray(data["v?"]), [False, True])


def test_dictionary_delta_growth():
    """Frames carry only NEW strings; the server LUT grows per frame and
    ids stay stable across frames."""
    enc = WireEncoder()
    d = StringDictionary()
    reg = DecoderRegistry()

    def send(names):
        frame = enc.encode({"sym": np.array(names, dtype=object),
                            "v": np.zeros(len(names)),
                            "n": np.zeros(len(names), np.int64)})
        data, _ = decode_frame(frame, DEF3, d, reg)
        return data

    d1 = send(["a", "b"])
    d2 = send(["b", "c"])          # delta carries only "c"
    d3 = send(["a", "c", "d"])     # delta carries only "d"
    assert _strings_of(d1, d) == ["a", "b"]
    assert _strings_of(d2, d) == ["b", "c"]
    assert _strings_of(d3, d) == ["a", "c", "d"]
    # same client string -> same server id across frames
    assert d1["sym"][0] == d3["sym"][0]
    assert d2["sym"][1] == d3["sym"][1]
    assert len(d) == 4


def test_delta_gap_rejected_and_reset_recovers():
    """A decoder that lost the LUT (restart/eviction) rejects the next
    delta frame with a clean error; WireEncoder.reset() resends from a
    full dictionary and recovery is exact."""
    enc = WireEncoder()
    d = StringDictionary()
    reg = DecoderRegistry()
    f1 = enc.encode({"sym": np.array(["a", "b"], dtype=object),
                     "v": np.zeros(2), "n": np.zeros(2, np.int64)})
    decode_frame(f1, DEF3, d, reg)
    f2 = enc.encode({"sym": np.array(["c"], dtype=object),
                     "v": np.zeros(1), "n": np.zeros(1, np.int64)})
    fresh = DecoderRegistry()      # the server lost its state
    with pytest.raises(SiddhiAppValidationException,
                       match="dictionary delta gap"):
        decode_frame(f2, DEF3, d, fresh)
    enc.reset()
    f3 = enc.encode({"sym": np.array(["c", "a"], dtype=object),
                     "v": np.zeros(2), "n": np.zeros(2, np.int64)})
    data, _ = decode_frame(f3, DEF3, d, fresh)
    assert _strings_of(data, d) == ["c", "a"]


def test_registry_scope_partitions_encoder_state():
    """One encoder posting to TWO apps (scopes): each scope keeps its
    own LUT against its own dictionary — app B must never gather app
    A's server ids."""
    enc = WireEncoder()
    reg = DecoderRegistry()
    dA, dB = StringDictionary(), StringDictionary()
    dA.encode("shift-A")            # skew A's id space vs B's
    f1 = enc.encode({"sym": np.array(["x"], dtype=object),
                     "v": np.zeros(1), "n": np.zeros(1, np.int64)})
    a1, _ = decode_frame(f1, DEF3, dA, reg, scope="A")
    # same frame bytes into scope B: fresh LUT (dict_base 0), B's ids
    b1, _ = decode_frame(f1, DEF3, dB, reg, scope="B")
    assert _strings_of(a1, dA) == ["x"] and _strings_of(b1, dB) == ["x"]
    assert int(a1["sym"][0]) != int(b1["sym"][0])   # distinct id spaces
    # delta continuity advances independently per scope
    f2 = enc.encode({"sym": np.array(["y"], dtype=object),
                     "v": np.zeros(1), "n": np.zeros(1, np.int64)})
    a2, _ = decode_frame(f2, DEF3, dA, reg, scope="A")
    b2, _ = decode_frame(f2, DEF3, dB, reg, scope="B")
    assert _strings_of(a2, dA) == ["y"] and _strings_of(b2, dB) == ["y"]


def test_pre_encoded_int_string_column():
    """Numeric columns under a STRING attribute are rejected — silent
    misinterpretation of raw ints as dictionary ids is the bug class
    the type codes exist to stop."""
    enc = WireEncoder()
    frame = enc.encode({"sym": np.array([0, 1], np.int64),
                        "v": np.zeros(2), "n": np.zeros(2, np.int64)})
    with pytest.raises(SiddhiAppValidationException,
                       match="string attribute"):
        _decode(frame)


# ------------------------------------------------- corruption / truncation


def _frame():
    enc = WireEncoder()
    return enc.encode({"sym": np.array(["a", "b", "c"], dtype=object),
                       "v": np.arange(3, dtype=np.float64),
                       "n": np.arange(3, dtype=np.int64)},
                      timestamps=np.arange(3, dtype=np.int64))


@pytest.mark.parametrize("cut", [0, 3, 12, 47, 60, -8, -1])
def test_truncated_frames_rejected(cut):
    frame = _frame()
    with pytest.raises(SiddhiAppValidationException, match="wire frame"):
        _decode(frame[:cut] if cut >= 0 else frame[:len(frame) + cut])


def test_bad_magic_and_version():
    frame = bytearray(_frame())
    frame[:4] = b"NOPE"
    with pytest.raises(SiddhiAppValidationException, match="magic"):
        _decode(bytes(frame))
    frame = bytearray(_frame())
    frame[4] = 99
    with pytest.raises(SiddhiAppValidationException, match="version"):
        _decode(bytes(frame))


def test_missing_column_rejected():
    enc = WireEncoder()
    frame = enc.encode({"sym": np.array(["a"], dtype=object),
                        "v": np.zeros(1)})    # 'n' absent
    with pytest.raises(SiddhiAppValidationException,
                       match="column 'n' missing"):
        _decode(frame)


def test_client_id_out_of_dictionary_range():
    """A hand-crafted frame whose string column references an id the
    dictionary delta never defined is rejected, not gathered out of
    bounds."""
    header = struct.Struct("<4sHHQIIIHHIIQ")
    name = b"sym"
    dir_entry = (struct.pack("<H", len(name)) + name
                 + struct.pack("<BBQQ", 6, 0, 0, 8))
    payload = np.array([7, -1], np.int32).tobytes()
    frame = header.pack(MAGIC, 1, 0, 42, 0, 0, 2, 1, 0,
                        len(dir_entry), 0, len(payload)) \
        + dir_entry + payload
    with pytest.raises(SiddhiAppValidationException,
                       match="outside the 0-entry dictionary"):
        decode_frame(frame, _definition([("sym", AttrType.STRING)]),
                     StringDictionary(), DecoderRegistry())


def test_offset_escape_rejected():
    header = struct.Struct("<4sHHQIIIHHIIQ")
    name = b"v"
    dir_entry = (struct.pack("<H", len(name)) + name
                 + struct.pack("<BBQQ", 1, 0, 1 << 20, 8))
    payload = b"\0" * 16
    frame = header.pack(MAGIC, 1, 0, 1, 0, 0, 2, 1, 0,
                        len(dir_entry), 0, len(payload)) \
        + dir_entry + payload
    with pytest.raises(SiddhiAppValidationException, match="escapes"):
        decode_frame(frame, _definition([("v", AttrType.DOUBLE)]),
                     StringDictionary(), DecoderRegistry())


# ----------------------------------------- hello negotiation / control


def test_hello_round_trip():
    hello = negotiate_hello(encode_hello(sender_id=42))
    assert hello.kind == CTRL_HELLO
    assert hello.version == VERSION and hello.a == 42
    assert hello.capabilities == CAPABILITIES
    assert hello.capabilities & CAP_TS
    assert hello.capabilities & CAP_DICT_DELTA
    assert hello.capabilities & CAP_CONTROL


def test_hello_version_mismatch_names_both_versions():
    """A v2 encoder against this v1 decoder (and vice versa) fails at
    negotiation with an error naming BOTH versions — never a
    frame-parse error."""
    with pytest.raises(SiddhiAppValidationException) as ei:
        negotiate_hello(encode_hello(version=VERSION + 1))
    msg = str(ei.value)
    assert f"version {VERSION + 1}" in msg
    assert f"version {VERSION}" in msg


def test_data_frame_version_mismatch_names_both_versions():
    frame = bytearray(_frame())
    frame[4] = VERSION + 1
    with pytest.raises(SiddhiAppValidationException) as ei:
        _decode(bytes(frame))
    msg = str(ei.value)
    assert f"version {VERSION + 1}" in msg
    assert f"version {VERSION}" in msg
    assert "hello" in msg          # points at the negotiation path


def test_hello_capability_narrowing_and_requirements():
    # a peer offering extra future bits: narrowed to the mutual set
    h = negotiate_hello(encode_hello(capabilities=CAPABILITIES | (1 << 30)))
    assert h.capabilities == CAPABILITIES
    # a required capability the peer lacks is a clean negotiation error
    with pytest.raises(SiddhiAppValidationException, match="capability"):
        negotiate_hello(encode_hello(capabilities=CAP_TS),
                        required=CAP_CONTROL)


def test_control_frames_round_trip_and_stay_off_the_data_path():
    for kind, a, b, body in [
            (CTRL_HEARTBEAT, 7, 123, b""),
            (CTRL_SEQ_ACK, 1, 99, b""),
            (CTRL_CHECKPOINT_CUT, 2, 5, b'{"rev": "r1"}')]:
        buf = encode_control(kind, a=a, b=b, body=body)
        assert is_control(buf)
        cf = decode_control(buf)
        assert (cf.kind, cf.a, cf.b, cf.body) == (kind, a, b, body)
    # control frames bounce off decode_frame with a clean error...
    with pytest.raises(SiddhiAppValidationException, match="control"):
        _decode(encode_control(CTRL_HEARTBEAT))
    # ...and data frames bounce off decode_control symmetrically
    assert not is_control(_frame())
    with pytest.raises(SiddhiAppValidationException, match="data frame"):
        decode_control(_frame())
    with pytest.raises(SiddhiAppValidationException, match="truncated"):
        decode_control(encode_control(CTRL_CHECKPOINT_CUT,
                                      body=b"x" * 10)[:-4])


# ----------------------------------------------------- LRU eviction fix


def test_lru_eviction_raises_reset_error_and_counts():
    """A live connection's encoder state evicted by a tiny LRU must
    fail the NEXT frame with the documented WireEncoder.reset() error
    naming the eviction — not a generic gap error, and never (for an
    encoder with an empty LUT) silent acceptance."""
    reg = DecoderRegistry(max_encoders=2)
    d = StringDictionary()
    encs = [WireEncoder() for _ in range(3)]

    def frame_of(enc, names):
        return enc.encode({"sym": np.array(names, dtype=object),
                           "v": np.zeros(len(names)),
                           "n": np.zeros(len(names), np.int64)})

    # three encoders through a 2-slot LRU: encoder 0 is evicted
    for enc in encs:
        decode_frame(frame_of(enc, ["a", "b"]), DEF3, d, reg)
    assert reg.evictions == 1
    # encoder 0's next DELTA frame: the eviction-specific error
    with pytest.raises(SiddhiAppValidationException) as ei:
        decode_frame(frame_of(encs[0], ["a", "c"]), DEF3, d, reg)
    msg = str(ei.value)
    assert "evicted" in msg and "WireEncoder.reset" in msg
    # reset() recovers exactly (dict_base 0 re-bootstraps)
    encs[0].reset()
    data, _ = decode_frame(frame_of(encs[0], ["a", "c"]), DEF3, d, reg)
    assert _strings_of(data, d) == ["a", "c"]


def test_lru_eviction_error_even_with_empty_lut():
    """The silent-corruption corner: an evicted encoder whose LUT had
    no strings yet would previously pass the generic gap check
    (0 == 0). The eviction tracker must still refuse the frame."""
    reg = DecoderRegistry(max_encoders=1)
    d = StringDictionary()
    e1, e2 = WireEncoder(), WireEncoder()

    def no_string_frame(enc, base):
        # hand-roll dict_base continuity without strings: first frame
        # establishes the state, second claims a nonzero base
        f = enc.encode({"sym": np.array(["s"] * base, dtype=object),
                        "v": np.zeros(base), "n": np.zeros(base, np.int64)})
        return f

    decode_frame(no_string_frame(e1, 1), DEF3, d, reg)     # e1 live
    decode_frame(no_string_frame(e2, 1), DEF3, d, reg)     # evicts e1
    with pytest.raises(SiddhiAppValidationException,
                       match="evicted"):
        decode_frame(e1.encode(
            {"sym": np.array(["t"], dtype=object),
             "v": np.zeros(1), "n": np.zeros(1, np.int64)}), DEF3, d, reg)


# ------------------------------------------------------ property sweep


def test_property_random_schemas():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    attr_types = st.sampled_from(
        [AttrType.STRING, AttrType.LONG, AttrType.DOUBLE, AttrType.BOOL])
    schemas = st.lists(attr_types, min_size=1, max_size=5)

    @settings(max_examples=40, deadline=None)
    @given(
        schema=schemas,
        n_rows=st.integers(min_value=0, max_value=64),
        seed=st.integers(min_value=0, max_value=2**31 - 1),
    )
    def check(schema, n_rows, seed):
        rng = np.random.default_rng(seed)
        definition = _definition(
            [(f"a{i}", t) for i, t in enumerate(schema)])
        data = {}
        expect = {}
        for i, t in enumerate(schema):
            name = f"a{i}"
            if t == AttrType.STRING:
                col = np.array(
                    [None if rng.random() < 0.2
                     else f"s{rng.integers(0, 10)}-é"
                     for _ in range(n_rows)], dtype=object)
            elif t == AttrType.LONG:
                col = rng.integers(-1000, 1000, n_rows, dtype=np.int64)
            elif t == AttrType.DOUBLE:
                col = rng.random(n_rows)
            else:
                col = rng.integers(0, 2, n_rows).astype(bool)
            data[name] = col
            expect[name] = col
        ts = rng.integers(0, 1000, n_rows).astype(np.int64)
        enc = WireEncoder()
        d = StringDictionary()
        decoded, wts = decode_frame(
            enc.encode(data, timestamps=ts), definition, d,
            DecoderRegistry())
        assert np.array_equal(np.asarray(wts), ts)
        for i, t in enumerate(schema):
            name = f"a{i}"
            if t == AttrType.STRING:
                assert _strings_of(decoded, d, name) == list(expect[name])
            else:
                assert np.array_equal(np.asarray(decoded[name]),
                                      expect[name]), name

    check()


# ------------------------------------------------ across the two packages


def _ref_definition():
    from siddhi_tpu.query_api.definitions import Attribute as RA
    from siddhi_tpu.query_api.definitions import AttrType as RT
    from siddhi_tpu.query_api.definitions import StreamDefinition as RS

    return RS("S", attributes=[RA("sym", RT.STRING), RA("v", RT.DOUBLE),
                               RA("n", RT.LONG)])


def _cols(seed, n):
    rng = np.random.default_rng(seed)
    syms = np.array([f"k{i}" for i in rng.integers(0, 40, n)], dtype=object)
    syms[rng.random(n) < 0.1] = None
    return {"sym": syms, "v": rng.random(n), "v?": rng.random(n) < 0.05,
            "n": rng.integers(-5, 5, n).astype(np.int64)}, np.arange(n, dtype=np.int64)


@pytest.mark.parametrize("direction", ["port->reference", "reference->port"])
def test_frames_cross_between_the_packages(direction):
    """A frame sequence from one package's encoder decodes in the other's
    decoder to the same columns, dictionary deltas included."""
    from siddhi_tpu.core.event import StringDictionary as RefDict

    enc = WireEncoder(7) if direction == "port->reference" else ref_wire.WireEncoder(7)
    port = (StringDictionary(), DecoderRegistry())
    ref = (RefDict(), ref_wire.DecoderRegistry())
    for seed in range(3):
        data, ts = _cols(seed, 50)
        frame = enc.encode(data, timestamps=ts)
        got, got_ts = decode_frame(frame, DEF3, *port)
        want, want_ts = ref_wire.decode_frame(frame, _ref_definition(), *ref)
        assert np.array_equal(got_ts, want_ts)
        assert got.keys() == want.keys()
        for k in got:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert port[0]._to_str == ref[0]._to_str


APP = """
define stream S (sym string, v double, n long);
@info(name = 'q')
from S#window.length(20) select sym, sum(v) as sv, max(n) as mx group by sym
insert into Out;
"""


def _app_rows(pkg, wired):
    if pkg == "jax":
        m = siddhi_tpu.SiddhiManager()
        c = make_collector(siddhi_tpu.StreamCallback)
        w = ref_wire
    else:
        m = siddhi_tpu_torch.SiddhiManager(device="cpu")
        c = make_collector(siddhi_tpu_torch.StreamCallback)
        w = __import__("siddhi_tpu_torch.core.stream.input.wire", fromlist=["x"])
    rt = m.create_siddhi_app_runtime(APP)
    rt.add_callback("Out", c)
    h = rt.get_input_handler("S")
    enc, reg = w.WireEncoder(3), w.DecoderRegistry()
    defn = rt.junctions["S"].definition
    dic = rt.app_context.string_dictionary
    first_ids = None
    for seed in range(4):
        data, ts = _cols(10 + seed, 64)
        ts = ts + 64 * seed
        if wired:
            data, ts = w.decode_frame(enc.encode(data, timestamps=ts), defn, dic, reg)
        h.send_columns(data, timestamps=ts)
        if first_ids is None:
            first_ids = list(dic._to_str)
    m.shutdown()
    return c.rows, first_ids


def test_wire_ingest_equals_columns_ingest_in_both_packages():
    """The same batches sent as decoded frames and as plain columns give
    the same rows, the first batch's new strings the same ids, and the
    port's rows equal the reference's."""
    rows, ids = _app_rows("torch", wired=False)
    wrows, wids = _app_rows("torch", wired=True)
    assert wrows == rows and len(rows) == 4 * 64
    assert wids == ids
    ref_rows, ref_ids = _app_rows("jax", wired=True)
    assert wids == ref_ids
    assert_rows_match(wrows, ref_rows)


def test_read_only_frame_views_are_not_written():
    """The decoded non-string columns are read-only views of the frame;
    ingest copies them (never writes back), and the frame bytes are
    unchanged afterwards."""
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(APP)
    c = make_collector(siddhi_tpu_torch.StreamCallback)
    rt.add_callback("Out", c)
    data, ts = _cols(5, 32)
    frame = WireEncoder().encode(data, timestamps=ts)
    snapshot = bytes(frame)
    d, wts = decode_frame(frame, rt.junctions["S"].definition,
                          rt.app_context.string_dictionary, DecoderRegistry())
    assert not d["v"].flags.writeable
    rt.get_input_handler("S").send_columns(d, timestamps=wts)
    m.shutdown()
    assert frame == snapshot and len(c.rows) == 32
