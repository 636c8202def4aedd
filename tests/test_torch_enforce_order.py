"""``@app:enforceOrder`` and the app-level ``@app:async`` refusal on the
port (``core/stream/input/input_handler.py``, ``core/app_runtime.py``),
each case run through both packages on the CPU.

- ``@app:enforceOrder``: a send whose timestamp precedes its stream's
  watermark, or a batch whose own timestamps regress, raises the
  reference's ``ValueError`` before the clock moves; the annotation with
  ``@Async`` on a stream fails app creation.
- ``@app:async`` at app level fails app creation with the reference's
  ``SiddhiAppValidationException``.
"""

import functools

import numpy as np
import pytest

from torch_helpers import release_jax_programs  # noqa: F401 — autouse fixture

PKGS = ("jax", "torch")


def _pkg(name):
    if name == "jax":
        import siddhi_tpu as p
        from siddhi_tpu.compiler.errors import SiddhiAppValidationException
        from siddhi_tpu.core.event import Event

        return p.SiddhiManager, p.StreamCallback, Event, SiddhiAppValidationException
    import siddhi_tpu_torch as p
    from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
    from siddhi_tpu_torch.core.event import Event

    return (functools.partial(p.SiddhiManager, device="cpu"), p.StreamCallback,
            Event, SiddhiAppValidationException)


def _collector(base):
    class C(base):
        def __init__(self):
            super().__init__()
            self.rows = []

        def receive(self, events):
            self.rows.extend(list(e.data) for e in events)

    return C()


@pytest.mark.parametrize("pkg", PKGS)
def test_enforce_order_refuses_a_send_behind_the_watermark(pkg):
    """The feed of the fault: ``send(1000, [1])`` then ``send(500, [2])``."""
    Manager, Callback, _Event, _Exc = _pkg(pkg)
    m = Manager()
    rt = m.create_siddhi_app_runtime(
        "@app:enforceOrder @app:playback define stream S (v int); "
        "from S select v insert into O;")
    c = _collector(Callback)
    rt.add_callback("O", c)
    h = rt.get_input_handler("S")
    h.send(1000, [1])
    with pytest.raises(ValueError, match=r"@app:enforceOrder: event timestamp 500 "
                                         r"precedes stream 'S' watermark 1000"):
        h.send(500, [2])
    # refused before the clock moved and before delivery
    assert rt.app_context.timestamp_generator.current_time() == 1000
    m.shutdown()
    assert c.rows == [[1]]


@pytest.mark.parametrize("pkg", PKGS)
def test_enforce_order_rejects_out_of_order_and_async(pkg):
    """The cases of ``tests/test_long_tail.py``'s scenario of that name."""
    Manager, Callback, Event, Exc = _pkg(pkg)
    m = Manager()
    rt = m.create_siddhi_app_runtime("""
        @app:enforceOrder @app:playback
        define stream S (v int);
        from S select v insert into Out;
    """)
    c = _collector(Callback)
    rt.add_callback("Out", c)
    h = rt.get_input_handler("S")
    h.send(1000, [1])
    h.send(2000, [2])
    with pytest.raises(ValueError, match="enforceOrder"):
        h.send(1500, [3])          # behind the stream watermark
    with pytest.raises(ValueError, match="enforceOrder"):
        h.send_columns({"v": np.array([4, 5])},
                       timestamps=np.array([3000, 2500]))  # in-batch regress
    with pytest.raises(ValueError, match="enforceOrder"):
        # in-batch regression through the Event-list form too
        h.send([Event(timestamp=3000, data=[7]), Event(timestamp=2600, data=[8])])
    h.send(3000, [6])              # monotone again: fine
    m.shutdown()
    assert c.rows == [[1], [2], [6]]

    # @Async buffering can reorder across producers: refused at build time
    with pytest.raises(Exc, match="enforceOrder"):
        Manager().create_siddhi_app_runtime("""
            @app:enforceOrder
            @Async(buffer.size='64')
            define stream S (v int);
            from S select v insert into Out;
        """)


@pytest.mark.parametrize("pkg", PKGS)
def test_app_level_async_is_refused(pkg):
    Manager, _Callback, _Event, Exc = _pkg(pkg)
    with pytest.raises(Exc, match=r"^@Async not supported in SiddhiApp level, "
                                  r"instead use @Async with streams$"):
        Manager().create_siddhi_app_runtime(
            "@app:async @app:playback define stream S (v int); "
            "from S select v insert into O;")
