"""ring_exchange: the port's counterpart of the repo's one Pallas kernel
(siddhi_tpu/parallel/mesh.py ``_pallas_ring_exchange``).

The Pallas kernel does not trace on this tree's JAX (see ROADMAP queue C),
so the port is held against the function its docstring defines and that
the reference runs off-TPU: ``lax.all_to_all(buf, axis, 0, 0, tiled=True)``
under ``shard_map``. The plain version must equal it exactly for every
shard count, dtype and row shape the routed step sends; the CUDA kernel is
held against the plain version on the card (``cuda``-marked test). jax
is imported only inside the reference comparison, so the card-side run
needs neither jax nor the reference's conftest:
``pytest --noconftest -m cuda tests/test_torch_exchange.py``."""

import functools

import numpy as np
import pytest
import torch
import torch_helpers  # noqa: F401 — one torch thread per test process

from siddhi_tpu_torch.ops.exchange import ring_exchange, ring_exchange_plain

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


@pytest.mark.cuda
def test_cuda_kernel_equals_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    for n in (2, 4, 8):
        for tail in ((), (3,)):
            for dt, buf in _send_buffers(n, tail).items():
                t = torch.from_numpy(buf).to(dev)
                before = ring_exchange.launches
                got = ring_exchange(t, n)
                torch.cuda.synchronize()
                assert ring_exchange.launches == before + 1
                assert torch.equal(got, ring_exchange_plain(t, n)), (n, tail, dt)
    # an odd row width: segment starts not 16-byte aligned (byte path)
    t = torch.arange(4 * 4 * 3, dtype=torch.int8, device=dev).view(4, 12)
    assert torch.equal(ring_exchange(t, 4), ring_exchange_plain(t, 4))
