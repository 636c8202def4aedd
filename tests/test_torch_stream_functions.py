"""Stream functions and string<->number casts (``ops/stream_functions.py``
and the planner's rewrites), held against the JAX package: #pol2Cart
before and after a window, a group key on a stream function's output (the
host transform path), #log taps, an extension stream function, and the
cases of tests/test_string_casts.py, each sent to both packages.

Tolerance (tests/torch_helpers.py): ints, strings, timestamps, types and
order exact; floats to rtol 1e-12."""

import logging

import pytest
from torch_helpers import assert_rows_match, make_collector


def _run(pkg, app, sends, out="OutStream", extensions=()):
    if pkg == "jax":
        import siddhi_tpu as P

        m = P.SiddhiManager()
    else:
        import siddhi_tpu_torch as P

        m = P.SiddhiManager(device="cpu")
    for name, make in extensions:
        m.set_extension(name, make(pkg))
    # playback: expired rows are stamped with the event clock
    rt = m.create_siddhi_app_runtime("@app:playback " + app)
    c = make_collector(P.StreamCallback)
    rt.add_callback(out, c)
    for i, (stream, row) in enumerate(sends):
        rt.get_input_handler(stream).send(1000 + i, row)
    m.shutdown()
    return c.rows


def _both(app, sends, **kw):
    got, want = _run("torch", app, sends, **kw), _run("jax", app, sends, **kw)
    assert_rows_match(got, want)
    return got


POLAR = "define stream PolarStream (theta double, rho double);"

CASES = {
    "pol2cart": (
        POLAR + "from PolarStream#pol2Cart(theta, rho) select x, y "
        "insert into OutStream;",
        [("PolarStream", [0.7854, 5.0]), ("PolarStream", [90.0, 2.0])]),
    "pol2cart_z_select_star": (
        POLAR + "from PolarStream#pol2Cart(theta, rho, 3.4) select * "
        "insert into OutStream;",
        [("PolarStream", [90.0, 2.0])]),
    "pol2cart_filter_window": (
        POLAR + "from PolarStream#pol2Cart(theta, rho)[y > 0.0]#window.length(2) "
        "select sum(y) as total insert into OutStream;",
        [("PolarStream", [90.0, 1.0]), ("PolarStream", [270.0, 1.0]),
         ("PolarStream", [90.0, 2.0])]),
    "pol2cart_group_by_output": (
        POLAR + "from PolarStream#pol2Cart(theta, rho) select x, count() as n "
        "group by x insert into OutStream;",
        [("PolarStream", [0.0, 2.0]), ("PolarStream", [0.0, 2.0]),
         ("PolarStream", [0.0, 3.0])]),
    "post_window_pol2cart": (
        POLAR + "from PolarStream#window.length(2)#pol2Cart(theta, rho)[y > 0.0] "
        "select y insert all events into OutStream;",
        [("PolarStream", [90.0, 1.0]), ("PolarStream", [270.0, 1.0]),
         ("PolarStream", [90.0, 2.0])]),
    "convert_string_to_double": (
        "define stream S (txt string); from S[convert(txt, 'double') > 10.0] "
        "select convert(txt, 'double') as v insert into OutStream;",
        [("S", [s]) for s in ["5.5", "42.25", "nope", "100"]]),
    "convert_string_to_long_window_sum": (
        "define stream S (txt string); from S#window.length(2) "
        "select sum(convert(txt, 'long')) as total insert into OutStream;",
        [("S", [s]) for s in ["3", "4", "5"]]),
    "convert_unparseable_is_null": (
        "define stream S (txt string); from S select convert(txt, 'double') as v "
        "insert into OutStream;",
        [("S", ["abc"]), ("S", ["1.5"])]),
    "convert_overflow_is_null": (
        "define stream S (txt string); from S select convert(txt, 'int') as v "
        "insert into OutStream;",
        [("S", [s]) for s in ["1e400", "3000000000", "7"]]),
    "convert_numeric_to_string": (
        "define stream S (v int, d double, b bool); from S select "
        "convert(v, 'string') as vs, convert(d, 'string') as ds, "
        "convert(b, 'string') as bs insert into OutStream;",
        [("S", [42, 1.5, True]), ("S", [-3, 0.25, False])]),
    "convert_numeric_to_string_in_filter": (
        "define stream S (v int); from S[convert(v, 'string') == '7'] "
        "select v insert into OutStream;",
        [("S", [v]) for v in [5, 7, 9]]),
    "cast_in_filter_select_star": (
        "define stream S (txt string, n long); from S[cast(txt, 'int') > 2] "
        "select * insert into OutStream;",
        [("S", [t, n]) for t, n in [("1", 5), ("3", 6), ("x", 7), ("4", 8)]]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stream_function_apps_match_reference(name):
    app, sends = CASES[name]
    assert _both(app, sends)


def _magnitude(pkg):
    if pkg == "jax":
        from siddhi_tpu.extension import StreamFunction
        from siddhi_tpu.query_api.definitions import AttrType
    else:
        from siddhi_tpu_torch.extension import StreamFunction
        from siddhi_tpu_torch.query_api.definitions import AttrType

    class Magnitude(StreamFunction):
        out_attrs = [("magnitude", AttrType.DOUBLE)]

        @staticmethod
        def apply(xp, a, b):
            return xp.sqrt(a * a + b * b)

    return Magnitude


@pytest.mark.parametrize("name", ["streamFunction:mag", "streamFunction:custom:mag"])
def test_extension_stream_function_matches_reference(name):
    fn = name.split(":", 1)[1]
    rows = _both("define stream Vec (x1 double, x2 double); "
                 f"from Vec#{fn}(x1, x2) select magnitude insert into OutStream;",
                 [("Vec", [3.0, 4.0]), ("Vec", [6.0, 8.0])],
                 extensions=[(name, _magnitude)])
    assert [d for _t, d, _e in rows] == [(5.0,), (10.0,)]


def test_log_taps_match_reference(caplog):
    app = ("define stream S (symbol string, price double); "
           "@info(name = 'q') from S#log('INFO', 'price event', true)[price > 10.0]"
           "#log('filtered') select symbol insert into OutStream;")
    sends = [("S", ["WSO2", 55.5]), ("S", ["CHEAP", 5.0])]
    logs = {}
    for pkg in ("jax", "torch"):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="siddhi"):
            rows = _run(pkg, app, sends)
        logs[pkg] = [r.getMessage() for r in caplog.records if r.name == "siddhi"]
        assert [d for _t, d, _e in rows] == [("WSO2",)]
    assert logs["torch"] == logs["jax"]
    assert len(logs["torch"]) == 3


@pytest.mark.parametrize("app, what", [
    (POLAR + "from PolarStream#noSuchThing(theta) select theta insert into O;",
     "unknown stream function"),
    ("define stream S (x double, v int); from S#pol2Cart(v, v) select x "
     "insert into O;", "collides"),
    ("define stream S (v int); from S#log('LOUD', 'oops') select v insert into O;",
     "log priority"),
])
def test_bad_stream_functions_are_refused(app, what):
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.ops.expressions import CompileError

    with pytest.raises(CompileError, match=what):
        SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
