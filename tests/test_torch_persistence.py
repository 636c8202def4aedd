"""Snapshots and persistence on the port (``core/util/snapshot.py``,
``core/util/persistence.py``, the runtime's persistence API), on the CPU.

- Every scenario of the reference's ``test_persistence.py`` drives the port
  through the module's own feed and checks the module's own expected rows
  (``torch_helpers.port_corpus``).
- The persist shapes of other reference modules, run on the port the same
  way: the join engine's layouts (engine <-> broadcast probe, P in {1, 4,
  8}), a checkpoint with a non-empty pipeline (join and single-stream
  queries), the mesh's routed <-> unrouted layouts, and a purged
  partition's key space across a revision.
- A routed join revision across packages: the reference persists its
  routed run and the port's unsharded runtime restores it and continues,
  equal to the uninterrupted run.
"""

import inspect

import pytest

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

_PERSISTENCE_MODULE, _PLAIN = port_corpus("test_persistence")
# the plain scenarios and the one that takes pytest's tmp_path
PERSISTENCE = (_PERSISTENCE_MODULE, sorted(_PLAIN + [
    k for k, v in vars(_PERSISTENCE_MODULE).items()
    if k.startswith("test_") and inspect.isfunction(v)
    and list(inspect.signature(v).parameters) == ["tmp_path"]]))
SHAPES = {
    "test_join_engine": (
        port_corpus("test_join_engine",
                    unported=("siddhi_tpu.observability.export",))[0],
        ["test_legacy_snapshot_restores_into_engine",
         "test_cross_restore_partitioned_and_legacy_layouts",
         "test_checkpoint_restore_with_nonempty_pipeline_exactly_once"]),
    "test_mesh_routing": (port_corpus("test_mesh_routing")[0],
                          ["test_snapshot_cross_restore_between_layouts"]),
    "test_pipeline": (
        port_corpus("test_pipeline", unported=("siddhi_tpu.resilience.faults",))[0],
        ["test_checkpoint_drains_pipeline_and_restore_discards_it"]),
    "test_partition_purge": (port_corpus("test_partition_purge")[0],
                             ["test_purge_survives_persistence_roundtrip"]),
}


def _shape_cases():
    cases = []
    for mod, (m, names) in SHAPES.items():
        for name in names:
            fn = getattr(m, name)
            marks = [k for k in getattr(fn, "pytestmark", []) if k.name == "parametrize"]
            if not marks:
                cases.append((mod, name, {}))
                continue
            argnames = [a.strip() for a in marks[0].args[0].split(",")]
            for values in marks[0].args[1]:
                values = values if len(argnames) > 1 else (values,)
                cases.append((mod, name, dict(zip(argnames, values))))
    return cases


def test_every_persistence_scenario_is_collected():
    assert len(PERSISTENCE[1]) == 13, PERSISTENCE[1]


@pytest.mark.parametrize("name", PERSISTENCE[1])
def test_persistence_corpus_on_port(name, tmp_path):
    fn = getattr(PERSISTENCE[0], name)
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path=tmp_path)
    else:
        fn()


@pytest.mark.parametrize("module,name,kwargs", _shape_cases(),
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}={x}" for k, x in v.items()) or "plain")
def test_persist_shape_on_port(module, name, kwargs):
    getattr(SHAPES[module][0], name)(**kwargs)


def test_routed_join_revision_of_the_reference_restores_unsharded():
    """The reference's ``test_routed_join_cross_restores_to_unsharded``
    across packages: its routed (2-shard) partitioned join persists half
    the feed; the port's unsharded runtime restores that revision and
    continues; head + tail equal the port's uninterrupted run and the
    reference's."""
    from siddhi_tpu.core.util.persistence import InMemoryPersistenceStore as RefStore
    from siddhi_tpu.parallel.mesh import device_route_query_step, make_mesh

    import tests.test_join_engine as ref
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore

    port = SHAPES["test_join_engine"][0]
    m, rt, c = port._build(app=port.PART_APP)
    port._feed_part(rt, 0, 160)
    want = list(c.rows)
    m.shutdown()

    rstore = RefStore()
    m1, rt1, c1 = ref._build(app=ref.PART_APP, store=rstore)
    device_route_query_step(rt1.query_runtimes["pj"], make_mesh(2), rows_per_shard=256)
    ref._feed_part(rt1, 0, 80)
    rev = rt1.persist()
    head = list(c1.rows)
    ref._feed_part(rt1, 80, 160)
    ref_rows = list(c1.rows)
    name = rt1.name
    m1.shutdown()
    assert ref_rows == want

    store = InMemoryPersistenceStore()
    store.save(name, rev, rstore.load(name, rev))
    m2, rt2, c2 = port._build(app=port.PART_APP, store=store)
    assert rt2.name == name
    rt2.restore_revision(rev)
    port._feed_part(rt2, 80, 160)
    m2.shutdown()
    assert head + c2.rows == want
