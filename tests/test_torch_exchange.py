"""ring_exchange: the port's counterpart of the repo's one Pallas kernel
(siddhi_tpu/parallel/mesh.py ``_pallas_ring_exchange``).

The Pallas kernel does not trace on this tree's JAX (see ROADMAP queue C),
so the port is held against the function its docstring defines and that
the reference runs off-TPU: ``lax.all_to_all(buf, axis, 0, 0, tiled=True)``
under ``shard_map``. The plain version must equal it exactly for every
shard count, dtype and row shape the routed step sends; the CUDA kernel is
held against the plain version on the card (``cuda``-marked test), one
buffer at a time and many columns of mixed dtypes per call. jax
is imported only inside the reference comparison, so the card-side run
needs neither jax nor the reference's conftest:
``pytest --noconftest -m cuda tests/test_torch_exchange.py``."""

import functools

import numpy as np
import pytest
import torch
import torch_helpers  # noqa: F401 — one torch thread per test process

from siddhi_tpu_torch.ops.exchange import (
    ARENA_ALIGN,
    arena_views,
    ring_exchange,
    ring_exchange_cols,
    ring_exchange_cols_plain,
    ring_exchange_plain,
)

DTYPES = ["int64", "int32", "int8", "bool", "float32", "float64"]
Q = 5


def _send_buffers(n, tail):
    """[n, n*Q, *tail] send buffers, one per dtype, from a fixed seed."""
    rng = np.random.default_rng(n * 10 + len(tail))
    shape = (n, n * Q) + tail
    out = {}
    for dt in DTYPES:
        if dt == "bool":
            out[dt] = rng.random(shape) < 0.5
        elif dt.startswith("float"):
            out[dt] = (rng.standard_normal(shape) * 100).astype(dt)
        else:
            info = np.iinfo(dt)
            out[dt] = rng.integers(info.min, info.max, shape, dtype=dt)
    return out


@functools.lru_cache(maxsize=None)
def _jax_all_to_all(n, tail):
    """The reference exchange: every dtype's buffer through one shard_map
    of ``lax.all_to_all(tiled=True)`` over an n-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    bufs = _send_buffers(n, tail)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("keys",))

    def body(*xs):
        return tuple(jax.lax.all_to_all(x, "keys", 0, 0, tiled=True) for x in xs)

    # the global array is [n * n*Q, *tail]: shard s holds its send buffer
    spec = P("keys")
    fn = shard_map(body, mesh=mesh, in_specs=(spec,) * len(DTYPES),
                   out_specs=(spec,) * len(DTYPES))
    outs = jax.jit(fn)(*(jnp.asarray(bufs[d].reshape((n * n * Q,) + tail))
                         for d in DTYPES))
    return {d: np.asarray(o).reshape((n, n * Q) + tail)
            for d, o in zip(DTYPES, outs)}


@pytest.mark.parametrize("tail", [(), (3,)], ids=["flat", "tail3"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_equals_lax_all_to_all(n, dtype, tail):
    buf = _send_buffers(n, tail)[dtype]
    want = _jax_all_to_all(n, tail)[dtype]
    got = ring_exchange_plain(torch.from_numpy(buf), n).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_tensor_runs_plain_and_counts_no_launch():
    buf = torch.arange(4 * 8 * 2, dtype=torch.int64).view(4, 8, 2)
    before = ring_exchange.launches
    out = ring_exchange(buf, 4)
    assert ring_exchange.launches == before
    assert torch.equal(out, ring_exchange_plain(buf, 4))
    # segment d of shard s lands at shard d, position s (source-major)
    assert torch.equal(out[2, 2:4], buf[1, 4:6])


@pytest.mark.parametrize("bad", ["n_mismatch", "ragged", "noncontig", "n_zero"])
def test_wrapper_rejects_bad_buffers(bad):
    buf = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "n_mismatch":
            ring_exchange(buf, 2)
        elif bad == "ragged":
            ring_exchange(torch.zeros(4, 9, dtype=torch.int32), 4)
        elif bad == "noncontig":
            ring_exchange(torch.zeros(8, 4, dtype=torch.int32).t(), 4)
        else:
            ring_exchange(buf, 0)


@pytest.mark.parametrize("tail", [(), (3,)], ids=["flat", "tail3"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_cols_plain_over_all_dtypes_equals_lax_all_to_all(n, tail):
    bufs = _send_buffers(n, tail)
    want = _jax_all_to_all(n, tail)
    got = ring_exchange_cols_plain([torch.from_numpy(bufs[d]) for d in DTYPES], n)
    assert len(got) == len(DTYPES)
    for d, g in zip(DTYPES, got):
        assert g.numpy().dtype == want[d].dtype
        np.testing.assert_array_equal(g.numpy(), want[d])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_one_buffer_form_is_the_cols_call(n):
    buf = torch.from_numpy(_send_buffers(n, (3,))["int32"])
    one = ring_exchange(buf, n)
    assert torch.equal(one, ring_exchange_cols([buf], n)[0])
    assert torch.equal(one, ring_exchange_plain(buf, n))


def test_cols_wrapper_on_cpu_counts_no_launch():
    bufs = [torch.from_numpy(b) for b in _send_buffers(4, ()).values()]
    before = (ring_exchange.launches, ring_exchange.columns)
    got = ring_exchange_cols(bufs, 4)
    assert (ring_exchange.launches, ring_exchange.columns) == before
    for g, w in zip(got, ring_exchange_cols_plain(bufs, 4)):
        assert torch.equal(g, w)
    assert ring_exchange_cols([], 4) == []


@pytest.mark.parametrize("bad", ["mixed_n", "ragged", "noncontig", "tail_1d"])
def test_cols_wrapper_rejects_bad_buffers(bad):
    good = torch.zeros(4, 8, dtype=torch.int32)
    other = {
        "mixed_n": torch.zeros(2, 8, dtype=torch.int64),
        "ragged": torch.zeros(4, 9, dtype=torch.int8),
        "noncontig": torch.zeros(8, 4, dtype=torch.int32).t(),
        "tail_1d": torch.zeros(4, dtype=torch.int32),
    }[bad]
    before = ring_exchange.launches
    with pytest.raises(ValueError):
        ring_exchange_cols([good, other], 4)
    assert ring_exchange.launches == before


def test_arena_views_are_aligned_contiguous_and_typed():
    specs = [((4, 20), torch.bool), ((4, 12, 3), torch.int64), ((2, 6), torch.int8),
             ((4, 0), torch.float32), ((8, 8), torch.float64), ((4, 4, 2), torch.int32)]
    views = arena_views(specs, torch.device("cpu"))
    storages = {v.untyped_storage().data_ptr() for v in views}
    assert len(storages) == 1                       # one allocation
    spans = []
    for v, (shape, dt) in zip(views, specs):
        assert v.dtype == dt and tuple(v.shape) == shape and v.is_contiguous()
        assert v.data_ptr() % ARENA_ALIGN == 0
        spans.append((v.data_ptr(), v.data_ptr() + v.numel() * v.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))   # disjoint
    for i, v in enumerate(views):                   # writable, independently
        v.fill_(i % 2 == 1 if v.dtype == torch.bool else i)
    for i, v in enumerate(views):
        if v.numel() and v.dtype != torch.bool:
            assert bool((v == i).all())


@pytest.mark.cuda
def test_cuda_kernel_equals_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    for n in (1, 2, 4, 8):
        for tail in ((), (3,)):
            bufs = [torch.from_numpy(b).to(dev) for b in _send_buffers(n, tail).values()]
            for t in bufs:                      # one buffer per launch
                before = ring_exchange.launches
                got = ring_exchange(t, n)
                torch.cuda.synchronize()
                assert ring_exchange.launches == before + 1
                assert torch.equal(got, ring_exchange_plain(t, n)), (n, tail, t.dtype)
            before = ring_exchange.launches     # every dtype in one launch
            got = ring_exchange_cols(bufs, n)
            torch.cuda.synchronize()
            assert ring_exchange.launches == before + 1
            for g, t in zip(got, bufs):
                assert torch.equal(g, ring_exchange_plain(t, n)), (n, tail, t.dtype)
    # 65 columns: two launches
    bufs = [torch.from_numpy(b).to(dev) for b in _send_buffers(4, ()).values()] * 11
    bufs = bufs[:65]
    before = ring_exchange.launches
    got = ring_exchange_cols(bufs, 4)
    torch.cuda.synchronize()
    assert ring_exchange.launches == before + 2
    assert all(torch.equal(g, ring_exchange_plain(t, 4)) for g, t in zip(got, bufs))
    # odd-byte and sub-16-byte segments (byte path), a segment over one
    # chunk with unaligned ends (head, bulk body, tail), and an odd row width
    g = torch.Generator().manual_seed(3)
    odd = [torch.randint(-128, 127, (4, 4 * 7), generator=g, dtype=torch.int8),
           torch.randint(0, 2, (4, 4 * 3), generator=g).bool(),
           torch.randint(-9, 9, (4, 4 * 5, 3), generator=g, dtype=torch.int16),
           torch.randint(-9, 9, (4, 4 * 7), generator=g, dtype=torch.int64),
           torch.randint(-128, 127, (4, 4 * 20483), generator=g, dtype=torch.int8),
           torch.rand((4, 4 * 5001), generator=g),
           torch.arange(4 * 4 * 3, dtype=torch.int8).view(4, 12)]
    odd = [t.to(dev) for t in odd]
    got = ring_exchange_cols(odd, 4)
    torch.cuda.synchronize()
    assert all(torch.equal(g, ring_exchange_plain(t, 4)) for g, t in zip(got, odd))
