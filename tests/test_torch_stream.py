"""The port's stream engine (``repro_torch.serve.cluster_service``) against
the reference package's (``repro.serve.cluster_service``), on the CPU.

Both engines take the same call sequence (tests/test_serve_stream.py's:
the four ``PHASE2_LAYOUTS`` at 2,048 points, K in {2, 4, 8}, round-robin,
sequential and shuffled orders, refresh cadence, eviction by age, TTL,
clear and ring overwrite, the emptied-shard path, comm accounting and
queries).  After every refresh the two are compared bit for bit: global
labels, dense local labels, slot maps, the stacked ClusterSets, the
cached pair-d2 matrix, the host mirrors, the meter's counts, the
counters and the published snapshot.  The port's clustering is also
held to its own ``ddc_host`` (``same_clustering``), as
tests/test_serve_stream.py holds the reference's.

Also here: ``shard_capacity`` / ``stream_batches`` and ``Journal`` equal
to the reference's, ``StreamConfig`` taking the tree and tracking, the constructor's
``ValueError``s, the sync query on an FMA-decided tie, and
``state_dict`` arrays equal key by key, restoring across the packages.
The fault model, the query tier over the engine and the facade's
``stream`` backend are in tests/test_torch_stream_faults.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import ddc as jddc  # noqa: E402
from repro.data import spatial as jsp  # noqa: E402
from repro.serve import cluster_service as jcs  # noqa: E402
from repro.serve import journal as jjournal  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402
from repro_torch.serve import cluster_service as tcs  # noqa: E402
from repro_torch.serve import journal as tjournal  # noqa: E402

N = 2048
LAYOUT_FIELDS = ("eps", "min_pts", "grid", "max_verts", "max_clusters")
CS_FIELDS = ("contours", "counts", "sizes", "valid", "overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def arr(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def eq(got, want, what=""):
    got, want = arr(got), arr(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


class Twin:
    """The port's engine (``device="cpu"``) and the reference's, driven by
    the same calls; ``refresh`` and ``query`` compare them."""

    def __init__(self, k, cap, ddc_kw, max_batch=256, faults=(None, None), **skw):
        jcfg = jddc.DDCConfig(**ddc_kw)
        self.j = jcs.ClusterService(
            jcs.StreamConfig(shards=k, capacity=cap, max_batch=max_batch, ddc=jcfg, **skw),
            meter=jddc.CommMeter(), faults=faults[1])
        self.t = tcs.ClusterService(
            tcs.StreamConfig(shards=k, capacity=cap, max_batch=max_batch,
                             ddc=tddc.DDCConfig.from_dict(dataclasses.asdict(jcfg)), **skw),
            meter=tddc.CommMeter(), faults=faults[0], device="cpu")
        self.refreshes = 0

    def both(self, name, *args, **kw):
        got = getattr(self.t, name)(*args, **kw)
        want = getattr(self.j, name)(*args, **kw)
        return got, want

    def ingest(self, shard, pts, t=None):
        self.both("ingest", shard, pts, t=t)

    def evict(self, name, *args):
        got, want = self.both(name, *args)
        assert got == want, (name, got, want)
        return got

    def refresh(self, **kw):
        self.both("refresh", **kw)
        self.refreshes += 1
        check(self.t, self.j)

    def query(self, q, **kw):
        got, want = self.both("query", q, **kw)
        eq(got.labels, want.labels, "query labels")
        assert (got.version, got.degraded, got.scanned_shards) == \
            (want.version, want.degraded, want.scanned_shards)
        return got


def check(t, j):
    """Every piece of state the two engines share, bit for bit."""
    assert (t._global is None) == (j._global is None)
    if j._global is not None:
        eq(t._glabels, j._glabels, "global labels")
        eq(t._maps, j._maps, "slot maps")
        for f in CS_FIELDS:
            eq(getattr(t._global, f), getattr(j._global, f), f"global {f}")
    eq(t._dense, j._dense, "dense local labels")
    for f in CS_FIELDS:
        eq(getattr(t._batch, f), getattr(j._batch, f), f"batch {f}")
    assert (t.pair_d2 is None) == (j.pair_d2 is None)
    if j.pair_d2 is not None:
        eq(t.pair_d2, j.pair_d2, "pair_d2")
    for name in ("_live", "_ts", "_seq", "_hpts"):
        for s, (a, b) in enumerate(zip(getattr(t, name), getattr(j, name))):
            eq(a, b, f"{name}[{s}]")
    for name in ("_head", "_count", "_dirty", "_next_seq", "_epoch", "_merged_epoch",
                 "_quarantined", "refreshes", "delta_refreshes", "retries",
                 "quarantine_events", "fenced_deltas", "query_chunks",
                 "query_shards_scanned", "degraded_queries", "_snapshot_version"):
        assert getattr(t, name) == getattr(j, name), name
    assert t._journal.entries_total == j._journal.entries_total
    assert t._journal.compactions == j._journal.compactions
    if j.meter is not None:
        assert t.meter.snapshot() == j.meter.snapshot()
    ts, js = t.snapshot(), j.snapshot()
    assert (ts is None) == (js is None)
    if js is not None:
        for f in ("version", "epoch", "eps", "bboxes", "quarantined", "n_live",
                  "n_clusters"):
            assert getattr(ts, f) == getattr(js, f), f
        for f in ("pts", "mask", "glabels"):
            eq(getattr(ts, f), getattr(js, f), f"snapshot {f}")
    for s in range(t.scfg.shards):
        for f in CS_FIELDS:
            eq(getattr(t.local_set(s), f), getattr(j.local_set(s), f), f"local {s} {f}")


def layout_kw(layout):
    spec = jsp.PHASE2_LAYOUTS[layout]
    return {f: spec[f] for f in LAYOUT_FIELDS}


def build(layout, k, capacity=None, **kw):
    pts = jsp.PHASE2_LAYOUTS[layout]["make"](N)
    cap = capacity or jsp.shard_capacity(N, k)
    return Twin(k, cap, layout_kw(layout), **kw), pts


def stream(tw, pts, k, order="round_robin", seed=None, batch=256, refresh_every=1):
    for i, (shard, chunk) in enumerate(
            tsp.stream_batches(pts, k, batch, order=order, seed=seed)):
        tw.ingest(shard, chunk)
        if refresh_every and (i + 1) % refresh_every == 0:
            tw.refresh()
    tw.refresh()


def assert_matches_host(svc, layout):
    """The port's streamed clustering equals its ``ddc_host`` on the same
    per-shard membership (tests/test_serve_stream.py's check)."""
    spec = jsp.PHASE2_LAYOUTS[layout]
    pts, parts, labels = svc.live()
    host, _, _ = tddc.ddc_host(pts, len(parts), spec["eps"], spec["min_pts"],
                               partition=parts, contour="grid")
    assert tddc.same_clustering(labels, host)
    return labels


# -- the data helpers and the journal ------------------------------------------

@pytest.mark.parametrize("n,k", [(2048, 2), (2048, 8), (640, 4), (1, 3), (0, 4), (7, 8)])
def test_shard_capacity_equals_reference(n, k):
    assert tsp.shard_capacity(n, k) == jsp.shard_capacity(n, k)


@pytest.mark.parametrize("order,seed", [("round_robin", None), ("sequential", None),
                                        ("shuffled", 0), ("shuffled", 11)])
@pytest.mark.parametrize("n,k,batch", [(2048, 8, 256), (1000, 3, 128), (5, 4, 2)])
def test_stream_batches_equal_reference(order, seed, n, k, batch):
    pts = np.random.default_rng(n).uniform(0, 1, (n, 2)).astype(np.float32)
    got = tsp.stream_batches(pts, k, batch, order=order, seed=seed)
    want = jsp.stream_batches(pts, k, batch, order=order, seed=seed)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        eq(a, b)
    with pytest.raises(ValueError):
        tsp.stream_batches(pts, k, batch, order="lifo")


def test_journal_replay_equals_reference():
    """A seeded sequence of ingests and kills, with compactions: the two
    journals replay to the same arrays (and dtypes) after every entry."""
    rng = np.random.default_rng(4)
    k, cap = 3, 64
    a, b = tjournal.Journal(k, cap, limit=5), jjournal.Journal(k, cap, limit=5)
    mirrors = [[np.zeros((cap, 2), np.float32), np.zeros(cap, bool),
                np.full(cap, -np.inf), np.full(cap, -1, np.int64)] for _ in range(k)]
    seq = 0
    for step in range(60):
        s = int(rng.integers(k))
        pts, live, ts, sq = mirrors[s]
        if rng.random() < 0.7:
            nb = int(rng.integers(1, 20))
            slots = rng.choice(cap, nb, replace=False)
            chunk = rng.uniform(0, 1, (nb, 2)).astype(np.float32)
            stamps = np.full(nb, float(step))
            seqs = np.arange(seq, seq + nb)
            seq += nb
            for jr in (a, b):
                jr.record_ingest(s, slots, chunk, stamps, seqs)
            pts[slots], live[slots], ts[slots], sq[slots] = chunk, True, stamps, seqs
        else:
            kill = live & (rng.random(cap) < 0.3)
            for jr in (a, b):
                jr.record_kill(s, kill)
            live[kill] = False
        for jr in (a, b):
            if jr.needs_compaction(s):
                jr.compact(s, pts, live, ts, sq)
        for x, y, m in zip(a.replay(s), b.replay(s), mirrors[s]):
            eq(x, y)
            eq(x, m)
    assert (a.entries_total, a.compactions) == (b.entries_total, b.compactions)
    assert a.compactions > 0
    assert [a.entry_count(s) for s in range(k)] == [b.entry_count(s) for s in range(k)]


# -- the configuration ----------------------------------------------------------

def test_stream_config_fields_equal_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcs.StreamConfig)
          if f.name != "ddc"]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcs.StreamConfig)
          if f.name != "ddc"]
    assert tf == jf


@pytest.mark.parametrize("kw,word", [(dict(agg_degree=2), "hierarchy"),
                                     (dict(agg_degree=4), "hierarchy"),
                                     (dict(track=True), "tracking")])
def test_tree_and_tracking_are_accepted(kw, word):
    """``StreamConfig`` takes ``agg_degree`` and ``track=True``; the engine
    then holds the tree (``pair_d2`` None) or the tracker, as the
    reference's does."""
    scfg = tcs.StreamConfig(shards=2, capacity=64, max_batch=64, **kw)
    svc = tcs.ClusterService(scfg, device="cpu")
    ref = jcs.ClusterService(jcs.StreamConfig(shards=2, capacity=64, max_batch=64, **kw))
    if word == "hierarchy":
        assert svc.hierarchy is not None and svc.tracker is None
        assert svc.hierarchy.degree == kw["agg_degree"] == ref.hierarchy.degree
        assert svc.hierarchy.device == svc.device
    else:
        assert svc.tracker is not None and svc.hierarchy is None
        assert svc.track_snapshot() is None
    assert svc.pair_d2 is None and ref.pair_d2 is None
    assert svc.state_dict()[1] == ref.state_dict()[1]


@pytest.mark.parametrize("kw,match", [(dict(merge_mode="eager"), "eager"),
                                      (dict(capacity=100, max_batch=128), "capacity 100")])
def test_constructor_value_errors_equal_reference(kw, match):
    kw = dict(dict(shards=2, capacity=512), **kw)
    msgs = []
    for mod, extra in ((tcs, {"device": "cpu"}), (jcs, {})):
        with pytest.raises(ValueError, match=match) as e:
            mod.ClusterService(mod.StreamConfig(**kw), **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_shard_range_equals_reference():
    tw, pts = build("rings", 2)
    for bad in (-1, 2):
        msgs = []
        for svc in (tw.t, tw.j):
            with pytest.raises(ValueError, match="out of range") as e:
                svc.ingest(bad, pts[:4])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcs.ClusterService(tcs.StreamConfig(shards=2, capacity=256))
    tcs.ClusterService(tcs.StreamConfig(shards=2, capacity=256), device="cpu")


# -- streaming == reference, after every refresh --------------------------------

# Each (layout, K) cell runs one ingest order: K 2 sequential (refreshed
# every second chunk), K 4 round-robin, K 8 shuffled (refreshed every chunk).
ORDERS = {2: ("sequential", None, 2), 4: ("round_robin", None, 1), 8: ("shuffled", 5, 1)}


@pytest.mark.parametrize("k", sorted(ORDERS))
@pytest.mark.parametrize("layout", sorted(jsp.PHASE2_LAYOUTS))
def test_stream_equals_reference(layout, k):
    order, seed, every = ORDERS[k]
    tw, pts = build(layout, k)
    stream(tw, pts, k, order=order, seed=seed, refresh_every=every)
    assert tw.refreshes >= 5
    assert tw.t.delta_refreshes == tw.j.delta_refreshes > 0
    assert_matches_host(tw.t, layout)
    tw.query(np.concatenate([pts[::5], pts[::9] + 0.003]).astype(np.float32))


def test_refresh_cadence_equals_reference():
    """Refreshing after every chunk, every third, or once at the end: the
    same clustering, and each run equal to the reference's at every
    refresh."""
    labels = []
    for every in (1, 3, 0):
        tw, pts = build("rings", 8)
        stream(tw, pts, 8, refresh_every=every)
        labels.append(assert_matches_host(tw.t, "rings"))
    assert tddc.same_clustering(labels[0], labels[1])
    assert tddc.same_clustering(labels[0], labels[2])


def test_delta_state_equals_full_remerge():
    tw, pts = build("linked_ovals", 4)
    stream(tw, pts, 4)
    d2, labels = tw.t.pair_d2, tw.t._glabels
    tw.both("remerge_full")
    check(tw.t, tw.j)
    eq(tw.t.pair_d2, d2)
    eq(tw.t._glabels, labels)


def test_merge_mode_full_equals_reference():
    tw, pts = build("worm", 4, merge_mode="full")
    stream(tw, pts, 4, refresh_every=2)
    assert tw.t.delta_refreshes == 0


# -- eviction ---------------------------------------------------------------------

def test_cleared_shard_takes_cached_empty_path():
    tw, pts = build("noise_heavy", 4)
    stream(tw, pts, 4, refresh_every=0)
    assert tw.evict("clear", 1) > 0
    tw.refresh()
    empty = tcs.empty_clusterset(tw.t.cfg, "cpu")
    assert tw.t.local_set(1).contours is empty.contours     # cached, not rebuilt
    assert len(tw.t.live()[1][1]) == 0
    assert_matches_host(tw.t, "noise_heavy")


def test_clear_all_shards_goes_global_empty():
    tw, pts = build("rings", 2)
    stream(tw, pts, 2, refresh_every=0)
    for s in range(2):
        tw.evict("clear", s)
    tw.refresh()
    assert tw.t.n_live() == 0 and int(tw.t.global_set.valid.sum()) == 0
    assert (tw.query(pts[:16]).labels == -1).all()


def test_ring_overwrite_equals_reference():
    """Ingesting past capacity overwrites the oldest points in place."""
    kw = dict(eps=0.05, min_pts=5, max_clusters=16, max_verts=64, grid=96)
    tw = Twin(2, 512, kw, max_batch=128)
    pts, _ = jsp.make_blobs(1400, 4, seed=3)
    for shard, chunk in tsp.stream_batches(pts, 2, 128):
        tw.ingest(shard, chunk)
    tw.refresh()
    live_pts, parts, labels = tw.t.live()
    assert len(live_pts) == 2 * 512
    host, _, _ = tddc.ddc_host(live_pts, 2, kw["eps"], kw["min_pts"], partition=parts,
                               contour="grid")
    assert tddc.same_clustering(labels, host)


def test_evictions_equal_reference():
    """Oldest-n, TTL with explicit stamps, a clear, re-ingest into the TTL
    holes, and a wrap past capacity, refreshed between each."""
    tw, pts = build("linked_ovals", 4, capacity=640)
    for i, (shard, chunk) in enumerate(tsp.stream_batches(pts, 4, 128)):
        tw.ingest(shard, chunk, t=float(i // 4))
    tw.refresh()
    assert tw.evict("evict_oldest", 2, 100) == 100
    tw.refresh()
    assert sum(tw.evict("evict_older_than", s, 2.0) for s in range(4)) > 0
    tw.refresh()
    assert tw.t.window_ts() == tw.j.window_ts()
    tw.ingest(0, pts[:300], t=np.linspace(5.0, 6.0, 300))
    tw.refresh()
    tw.ingest(3, pts[1024:1600])                  # past capacity: ring overwrite
    tw.refresh()
    assert tw.evict("evict_oldest", 1, 0) == 0
    assert tw.evict("clear", 2) > 0
    tw.refresh()
    assert tw.evict("clear", 2) == 0
    assert_matches_host(tw.t, "linked_ovals")
    tw.query(pts[::7])


# -- comm accounting and queries ------------------------------------------------

def test_comm_accounting_equals_reference():
    k = 8
    tw, pts = build("rings", k)
    stream(tw, pts, k, refresh_every=0)
    b, c = tw.t.cfg.buffer_bytes(), tw.t.cfg.max_clusters
    for svc in (tw.t, tw.j):
        svc.meter.reset()
    tw.ingest(0, pts[:8])
    tw.refresh()
    assert tw.t.meter.snapshot()["bytes_total"] == b + k * c * 4
    for svc in (tw.t, tw.j):
        svc.meter.reset()
    tw.both("remerge_full")
    check(tw.t, tw.j)
    assert tw.t.meter.snapshot()["bytes_total"] == k * b + k * c * 4
    before = tw.t.meter.snapshot()
    tw.refresh()                                  # nothing dirty: free
    assert tw.t.meter.snapshot() == before
    tw.ingest(2, pts[:8])
    tw.ingest(5, pts[8:16])
    tw.refresh()                                  # two dirty: update_pair_d2_many
    assert tw.t.meter.snapshot()["bytes_total"] == before["bytes_total"] + 2 * b + k * c * 4


def test_query_equals_reference():
    tw, pts = build("rings", 4)
    empty = tw.query(pts[:4])                     # empty service: version 0
    assert empty.version == 0 and (empty.labels == -1).all()
    stream(tw, pts, 4, refresh_every=0)
    live_pts, _, labels = tw.t.live()
    got = tw.query(live_pts[:400])
    clustered = labels[:400] >= 0
    np.testing.assert_array_equal(got.labels[clustered], labels[:400][clustered])
    far = tw.query(np.array([[5.0, 5.0], [-3.0, 7.0]]))
    assert (far.labels == -1).all() and far.scanned_shards == ()
    many = np.random.default_rng(1).uniform(0, 1, (700, 2)).astype(np.float32)
    tw.query(many)                                # three chunks of max_queries
    tw.ingest(0, pts[:32])                        # left dirty: query refreshes
    before = tw.t.refreshes
    tw.query(pts[:8])
    assert tw.t.refreshes == before + 1
    check(tw.t, tw.j)
    for legacy, stale in ((True, False), (False, True), (True, True)):
        got, want = tw.both("query", pts[:8], legacy=legacy, return_stale=stale)
        if stale:
            assert got[1] == want[1]
            got, want = got[0], want[0]
        eq(np.asarray(got), np.asarray(want))
        assert isinstance(got, np.ndarray) == legacy


def swapped_ties(n=128, seed=0):
    """tests/test_torch_query_tier.py's FMA-decided ties: per query two
    stored points at q + (a, b) and q + (b, a), whose FMA-free distances
    tie bit for bit while fma(dy, dy, dx·dx) may not."""
    rng = np.random.default_rng(seed)
    q = (0.5 + rng.integers(0, 1 << 22, (n, 2)) * 2.0 ** -24).astype(np.float32)
    d = (rng.integers(1 << 15, 1 << 17, (n, 2)) * 2.0 ** -24).astype(np.float32)
    pts = np.empty((1, 2 * n, 2), np.float32)
    pts[0, 0::2] = q + d
    pts[0, 1::2] = q + d[:, ::-1]
    return q, pts, np.ones((1, 2 * n), bool), np.arange(2 * n, dtype=np.int32)[None]


@pytest.mark.parametrize("qn", [128, 100])
def test_sync_query_fma_tie_equals_reference(qn):
    """The engine's sync query kernel (``_query_labels``) decides the ties
    as the reference's jitted one does, masks rows past ``qn``, and the
    FMA-free form would pick the other point in some of them."""
    q, pts, mask, glab = swapped_ties()
    got = tcs._query_labels(torch.tensor(q), qn, torch.tensor(pts), torch.tensor(mask),
                            torch.tensor(glab), 0.05).numpy()
    want = np.asarray(jcs._query_labels(jnp.asarray(q), qn, jnp.asarray(pts),
                                        jnp.asarray(mask), jnp.asarray(glab), 0.05))
    eq(got, want)
    assert (want[:qn] >= 0).all() and (want[qn:] == -1).all()
    diff = q[:, None, :] - pts[0][None]
    free = glab[0][np.argmin(diff[..., 0] ** 2 + diff[..., 1] ** 2, axis=1)]
    assert 0 < int((free[:qn] != want[:qn]).sum()) < qn


# -- state_dict ------------------------------------------------------------------

def test_state_dict_equals_reference_and_restores_across():
    """``state_dict`` arrays equal key by key (values and dtypes) with the
    same manifest; each package's state restores in the other, and the
    restored pair continues equal through another round."""
    tw, pts = build("linked_ovals", 4)
    stream(tw, pts[:1536], 4)
    tw.ingest(1, pts[1536:1600])                  # a dirty shard in the state
    (ta, tm), (ja, jm) = tw.t.state_dict(), tw.j.state_dict()
    assert sorted(ta) == sorted(ja)
    for key in ja:
        eq(ta[key], ja[key], key)
    assert tm == jm
    back = Twin.__new__(Twin)
    back.refreshes = 0
    back.t = tcs.ClusterService.from_state(tw.t.scfg, ja, jm, meter=tddc.CommMeter(),
                                           device="cpu")
    back.j = jcs.ClusterService.from_state(tw.j.scfg, ta, tm, meter=jddc.CommMeter())
    check(back.t, back.j)
    # A restore publishes once more, so the versions run one ahead.
    assert back.t._snapshot_version == tw.t._snapshot_version + 1
    for s in (tw, back):
        s.ingest(2, pts[1600:1700])
        s.refresh()
    for name in ("_glabels", "_maps", "_pair_d2", "_dense"):
        eq(getattr(back.t, name), getattr(tw.t, name), name)
    back.query(pts[::11])
