"""The port's tree of aggregators (``repro_torch.serve.hierarchy``) against
the reference package's and against the port's flat aggregator, on the
CPU.

The reference promises (DESIGN.md §13) that a ``ClusterService`` running
the tree (``agg_degree`` set) gives per-shard global labels and slot maps
bit-identical to the flat aggregator's on the same ingest schedule, with
every node cache equal to a from-scratch rebuild (``cache_exact``).  Here
each in-process case of tests/test_hierarchy.py runs three ways:

- the port's tree engine (``device="cpu"``) against the reference's tree
  engine through ``Twin`` (tests/test_torch_stream.py): after every
  refresh every shared piece of state bit for bit (global labels, maps,
  the global set, the stacked batch, the meter's counts, the counters,
  the snapshot), plus the tree's ``last_stats``, topology and node
  caches;
- the port's tree against the port's flat engine on the same calls:
  labels, maps, the global set's ``valid`` and ``sizes`` (root contours
  are re-extracted level by level and are not promised);
- ``cache_exact()``.

Also: a counterpart of the reference's slow ``test_hier_equals_flat_sweep``
(every ``PHASE2_LAYOUTS`` layout × {4, 8, 16} shards × degree {2, 4}),
sized with ``max_batch <= capacity`` (the reference's k = 16 cells pass
``max_batch=256`` with a capacity of 128, which its constructor refuses),
and the ``--smoke`` rows of ``BENCH_hierarchy.json`` rebuilt through the
port's ``AggregatorTree`` as ``benchmarks/hierarchy.py`` builds them,
their hardware-free fields equal to the committed file.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.ddc as J  # noqa: E402
import repro_torch.ddc as T  # noqa: E402
from repro.core import ddc as jddc  # noqa: E402
from repro.data import spatial as jsp  # noqa: E402
from repro.serve import hierarchy as jhier  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402
from repro_torch.serve import cluster_service as tcs  # noqa: E402
from repro_torch.serve import hierarchy as thier  # noqa: E402
from test_torch_stream import N, Twin, check, eq, layout_kw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Trio(Twin):
    """The port's tree engine and the reference's (``Twin``), plus the
    port's flat engine on the same calls; ``refresh`` compares all three."""

    def __init__(self, layout, k, degree, max_batch=256):
        cap = tsp.shard_capacity(N, k)
        super().__init__(k, cap, layout_kw(layout), max_batch=max_batch, agg_degree=degree)
        self.flat = tcs.ClusterService(
            tcs.StreamConfig(shards=k, capacity=cap, max_batch=max_batch, ddc=self.t.cfg),
            meter=tddc.CommMeter(), device="cpu")

    def both(self, name, *args, **kw):
        getattr(self.flat, name)(*args, **kw)
        return super().both(name, *args, **kw)

    def refresh(self, **kw):
        super().refresh(**kw)
        check_tree(self.t, self.j)
        assert_equiv(self.flat, self.t)


def check_tree(t, j):
    """The tree state the two packages share: topology, each node's
    children, batch, cache, summary and maps, and the last refresh's stats."""
    tt, jt = t.hierarchy, j.hierarchy
    assert (tt.depth, tt.n_nodes, tt.internal_edges, tt.ready) == \
        (jt.depth, jt.n_nodes, jt.internal_edges, jt.ready)
    assert tt.last_stats == jt.last_stats
    for tl, jl in zip(tt.levels, jt.levels, strict=True):
        for tn, jn in zip(tl, jl, strict=True):
            assert tn.children == jn.children
            for f in tddc.ClusterSet._fields:
                eq(getattr(tn.batch, f), getattr(jn.batch, f), f"node batch {f}")
            assert (tn.pair_d2 is None) == (jn.pair_d2 is None)
            if jn.pair_d2 is not None:
                eq(tn.pair_d2, jn.pair_d2, "node pair_d2")
                eq(tn.maps, jn.maps, "node maps")
                for f in tddc.ClusterSet._fields:
                    eq(getattr(tn.summary, f), getattr(jn.summary, f), f"node summary {f}")


def assert_equiv(flat, tree):
    """Bit-identical where the §13 contract promises it: per-shard global
    labels, slot maps, and the global set's occupancy (valid/sizes)."""
    eq(tree.live()[2], flat.live()[2], "labels")
    eq(tree._maps, flat._maps, "maps")
    eq(tree.global_set.valid, flat.global_set.valid, "valid")
    eq(tree.global_set.sizes, flat.global_set.sizes, "sizes")
    assert tree.hierarchy is not None and tree.pair_d2 is None
    assert tree.hierarchy.cache_exact(), "a node cache diverged from its rebuild"


def stream(tw, pts, k, batch=256):
    for shard, chunk in tsp.stream_batches(pts, k, batch):
        tw.ingest(shard, chunk)
        tw.refresh()
    tw.refresh()


def build_trio(layout, k, degree):
    return Trio(layout, k, degree), jsp.PHASE2_LAYOUTS[layout]["make"](N)


# -- topology -------------------------------------------------------------------

CPU = dict(device="cpu")


@pytest.mark.parametrize("shards,degree", [(16, 2), (16, 4), (5, 4), (1, 2), (7, 2), (64, 4),
                                           (64, 2)])
def test_topology_equals_reference(shards, degree):
    cfg = jddc.DDCConfig(**layout_kw("rings"))
    jt = jhier.AggregatorTree(shards, degree, cfg)
    tt = thier.AggregatorTree(shards, degree, tddc.DDCConfig(**layout_kw("rings")), **CPU)
    assert (tt.depth, tt.n_nodes, tt.internal_edges, tt.ready) == \
        (jt.depth, jt.n_nodes, jt.internal_edges, jt.ready)
    assert [[n.children for n in lvl] for lvl in tt.levels] == \
        [[n.children for n in lvl] for lvl in jt.levels]
    for lvl in tt.levels:
        for node in lvl:
            assert node.batch.contours.shape == (degree, cfg.max_clusters, cfg.max_verts, 2)
            assert node.batch.contours.device.type == "cpu"
            assert not bool(node.batch.valid.any())


def test_topology_shapes():
    cfg = tddc.DDCConfig(**layout_kw("rings"))
    t = thier.AggregatorTree(16, 2, cfg, **CPU)
    assert (t.depth, t.n_nodes, t.internal_edges) == (4, 15, 14)
    t = thier.AggregatorTree(16, 4, cfg, **CPU)
    assert (t.depth, t.n_nodes) == (2, 5)
    t = thier.AggregatorTree(5, 4, cfg, **CPU)          # ragged last group
    assert [len(lvl) for lvl in t.levels] == [2, 1]
    t = thier.AggregatorTree(1, 2, cfg, **CPU)          # degenerate single shard
    assert (t.depth, t.n_nodes, t.internal_edges) == (1, 1, 0)
    assert not t.ready
    t = thier.AggregatorTree(64, 4, cfg, **CPU)
    assert (t.depth, t.n_nodes) == (3, 21)
    t = thier.AggregatorTree(64, 2, cfg, **CPU)
    assert (t.depth, t.n_nodes) == (6, 63)


@pytest.mark.parametrize("shards,degree", [(8, 1), (8, 0), (0, 2), (-1, 4)])
def test_rejects_bad_shapes_like_reference(shards, degree):
    msgs = []
    for mod, cfg, kw in ((thier, tddc.DDCConfig(), CPU), (jhier, jddc.DDCConfig(), {})):
        with pytest.raises(ValueError) as e:
            mod.AggregatorTree(shards, degree, cfg, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        thier.AggregatorTree(4, 2, tddc.DDCConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tcs.ClusterService(tcs.StreamConfig(shards=4, capacity=256, agg_degree=2))


# -- the stream cells: port tree == reference tree == port flat -----------------

@pytest.mark.parametrize("layout,k,degree", [
    ("rings", 4, 2), ("linked_ovals", 8, 4), ("worm", 4, 4), ("noise_heavy", 8, 2)])
def test_stream_cells(layout, k, degree):
    tr, pts = build_trio(layout, k, degree)
    stream(tr, pts, k)
    assert tr.t.delta_refreshes == tr.j.delta_refreshes > 0, "tree never took the delta path"
    assert tr.t.meter.snapshot() == tr.j.meter.snapshot()
    assert tr.t.hierarchy.cache_exact() and tr.j.hierarchy.cache_exact()
    for a, b in zip(tr.t.hierarchy.cache_arrays(), tr.j.hierarchy.cache_arrays(), strict=True):
        eq(a, np.asarray(b), "cache_arrays")
    tr.query(pts[::7])


def test_depth1_root_cache_is_the_flat_cache():
    """k == degree collapses the tree to one node whose batch IS the
    shard batch — its cache must literally equal flat ``pair_d2``."""
    tr, pts = build_trio("rings", 4, 4)
    stream(tr, pts, 4)
    tree = tr.t.hierarchy
    assert (tree.depth, tree.n_nodes) == (1, 1)
    eq(tree.cache_arrays()[0], tr.flat.pair_d2.numpy(), "root cache")
    eq(tree.cache_arrays()[0], np.asarray(tr.j.hierarchy.cache_arrays()[0]), "root cache")


def test_quarantined_leaf_and_recovery():
    """Fencing a shard excludes it at its leaf node only; recovery is one
    ordinary delta patch — both states equal flat and the reference."""
    tr, pts = build_trio("linked_ovals", 8, 2)
    stream(tr, pts, 8)
    tr.both("_quarantine", 3, "test fence")
    tr.refresh(force=True)
    assert 3 in tr.t.quarantined
    got, want = tr.both("recover", 3)
    assert got and want
    tr.refresh(force=True)
    assert not tr.t.quarantined


def test_held_sets_survive_later_writes():
    """The engine's mirror and each node's batch are written in place; the
    global set, every node's summary and maps, and a published snapshot
    that a caller holds must not change with later refreshes."""
    tr, pts = build_trio("linked_ovals", 8, 2)
    stream(tr, pts[:1536], 8)
    tree = tr.t.hierarchy
    held = [tr.t.global_set, tr.t._maps, tr.t.snapshot().glabels]
    held += [n.summary for lvl in tree.levels for n in lvl]
    held += [n.maps for lvl in tree.levels for n in lvl]
    before = [tuple(t.clone() for t in x) if isinstance(x, tuple) else x.clone()
              for x in held]
    for shard in range(8):
        tr.ingest(shard, pts[1536 + 64 * shard:1600 + 64 * shard])
        tr.refresh()
    assert tr.t.global_set is not held[0]
    for x, y in zip(held, before, strict=True):
        for a, b in zip(*((x, y) if isinstance(x, tuple) else ((x,), (y,)))):
            eq(a, b, "a held tensor changed")


def test_state_roundtrip_keeps_tree_mode():
    """``state_dict`` equals the reference's key by key; each package's
    state restores in the other in tree mode (every node cache rebuilt),
    and the restored pair continues equal."""
    tr, pts = build_trio("rings", 4, 2)
    stream(tr, pts[:1536], 4)
    tr.ingest(1, pts[1536:1600])                   # a dirty shard in the state
    (ta, tm), (ja, jm) = tr.t.state_dict(), tr.j.state_dict()
    assert tm["agg_degree"] == jm["agg_degree"] == 2 and tm == jm
    assert sorted(ta) == sorted(ja) and "pair_d2" not in ta
    for key in ja:
        eq(ta[key], np.asarray(ja[key]), key)
    back = Twin.__new__(Twin)
    back.refreshes = 0
    back.t = tcs.ClusterService.from_state(tr.t.scfg, ja, jm, meter=tddc.CommMeter(),
                                           device="cpu")
    back.j = type(tr.j).from_state(tr.j.scfg, ta, tm, meter=jddc.CommMeter())
    assert back.t.hierarchy is not None and back.t.pair_d2 is None
    assert back.t.hierarchy.cache_exact()
    check(back.t, back.j)
    check_tree(back.t, back.j)
    for s in (tr, back):
        s.ingest(2, pts[1600:1700])
        s.refresh()
    eq(back.t._glabels, tr.t._glabels, "labels after restore")
    eq(back.t._maps, tr.t._maps, "maps after restore")


# -- the facade ------------------------------------------------------------------

@pytest.mark.parametrize("bad,backend", [(1, "stream"), (3, "stream"), (6, "stream"),
                                         (2, "host")])
def test_facade_rejects_bad_degrees_like_reference(bad, backend):
    msgs = []
    for mod in (T, J):
        with pytest.raises(mod.ConfigError) as e:
            mod.DDCConfig(backend=backend, agg_degree=bad).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_facade_manifest_roundtrip():
    cfg = T.DDCConfig(backend="stream", agg_degree=4).validate()
    assert T.DDCConfig.from_manifest(cfg.to_manifest()) == cfg
    assert cfg.to_manifest() == J.DDCConfig(backend="stream", agg_degree=4).validate() \
        .to_manifest()


def test_facade_labels_match_flat_and_reference():
    spec = tsp.PHASE2_LAYOUTS["rings"]
    pts = spec["make"](512)
    kw = dict(layout_kw("rings"), backend="stream", shards=4)
    flat = T.DDC(T.DDCConfig(**kw).validate(), device="cpu").fit(pts)
    tree = T.DDC(T.DDCConfig(agg_degree=2, **kw).validate(), device="cpu").fit(pts)
    ref = J.DDC(J.DDCConfig(agg_degree=2, **kw).validate()).fit(pts)
    eq(tree.labels_, flat.labels_, "facade labels vs flat")
    eq(tree.labels_, ref.labels_, "facade labels vs reference")
    assert tree.backend.service.hierarchy is not None
    assert tree.backend.service.pair_d2 is None
    got, want = tree.comm_stats(), ref.comm_stats()
    got.pop("jit_cache_entries"), want.pop("jit_cache_entries")    # process-wide
    assert got == want


# -- the sweep: every layout x {4, 8, 16} shards x degree {2, 4} ----------------

@pytest.mark.parametrize("k", [4, 8, 16])
@pytest.mark.parametrize("layout", sorted(jsp.PHASE2_LAYOUTS))
def test_tree_equals_flat_sweep(layout, k):
    """The port's tree against the port's flat engine, refreshed after
    every chunk; ``max_batch`` is at most the capacity (2,048 points in k
    rings of ceil(2048 / k))."""
    pts = tsp.PHASE2_LAYOUTS[layout]["make"](N)
    cap = tsp.shard_capacity(N, k)
    cfg = tddc.DDCConfig(**layout_kw(layout))
    engines = [tcs.ClusterService(tcs.StreamConfig(shards=k, capacity=cap,
                                                   max_batch=min(256, cap), agg_degree=deg,
                                                   ddc=cfg), device="cpu")
               for deg in (None, 2, 4)]
    for shard, chunk in tsp.stream_batches(pts, k, 256):
        for svc in engines:
            svc.ingest(shard, chunk)
            svc.refresh()
        for tree in engines[1:]:
            eq(tree._maps, engines[0]._maps, "maps")
            eq(tree._glabels, engines[0]._glabels, "labels")
    for tree in engines[1:]:
        assert_equiv(engines[0], tree)
        assert tree.delta_refreshes > 0


# -- BENCH_hierarchy.json's smoke rows -------------------------------------------

def _chip_smoke():
    """chip_smoke.py as a module: its BENCH_hierarchy.json row function is
    the one the card runs (it imports nothing at module level but the
    standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k,degree", [(16, 2), (16, 4), (32, 2), (32, 4)])
def test_bench_hierarchy_smoke_rows(k, degree):
    """The refresh sequence of ``benchmarks/hierarchy.py`` (build, steady
    single-dirty refreshes, churn toggles of shard 0) through the port's
    tree and flat fold on the CPU, by chip_smoke.py's row function, which runs
    every row on the card."""
    cs = _chip_smoke()
    want = next(r for r in json.loads((ROOT / "BENCH_hierarchy.json").read_text())["rows"]
                if (r["shards"], r["degree"]) == (k, degree))
    assert cs.BENCH_HIER_CFG == json.loads((ROOT / "BENCH_hierarchy.json").read_text())["cfg"]
    cfg, batch, batch_alt = cs.bench_hierarchy_batches(torch, np, tddc, k, "cpu")
    got = cs.bench_hierarchy_row(torch, tddc, thier, cfg, batch, batch_alt, k, degree, "cpu")
    assert got == {f: want[f] for f in cs.BENCH_HIER_FIELDS}
