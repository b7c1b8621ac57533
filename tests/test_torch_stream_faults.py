"""The port's stream engine under faults, behind the query tier and behind
the facade, against the reference package's, on the CPU.

- The failure model (tests/test_faults.py's stream cases): poison and
  corrupt deltas rejected before the pair-d2 cache, transient and
  exhausted drops with retries and backoff, duplicates fenced by epoch,
  a killed lane quarantined and recovered from the journal, recovery
  across journal compaction and across a snapshot, and a diverged replay
  refused.  Each faulted port engine equals the faulted reference engine
  (the same plan) after every refresh, and after recovery its fault-free
  twin bit for bit (labels and pair-d2).
- The query tier over the engine (tests/test_query_tier.py's stream
  cases): a tier read equals the engine's sync query and the reference's
  tier, a snapshot held across writes serves the pre-write state, a
  restore republishes with a continuing version, and quarantined shards
  are served stale or routed around as in the reference.
- The facade (tests/test_ddc_api.py's stream cases): host == stream
  through ``fit``, TTL ``expire``, ``partial_fit`` before ``fit`` needing
  a capacity, restores keeping the engine's counters, stream snapshots
  crossing between the packages both ways through ``DDC.save`` /
  ``DDC.load``, and ``stats()``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.ddc as J  # noqa: E402
import repro_torch.ddc as T  # noqa: E402
from repro.serve import cluster_service as jcs  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import query_tier as jqt  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402
from repro_torch.serve import cluster_service as tcs  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve import query_tier as tqt  # noqa: E402
from test_torch_stream import Twin, check, eq, layout_kw  # noqa: E402

N = 640
K = 4
BATCH = 160


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def plans(*events, **kw):
    """The same FaultPlan in both packages (a plan keeps per-shard delivery
    counters, so each engine needs its own)."""
    return (tfaults.FaultPlan(events=tuple(tfaults.FaultEvent(*e) for e in events), **kw),
            jfaults.FaultPlan(events=tuple(jfaults.FaultEvent(*e) for e in events), **kw))


def build(layout="rings", k=K, faults=(None, None), journal_limit=1024, max_retries=2,
          **skw):
    pts = tsp.PHASE2_LAYOUTS[layout]["make"](N)
    cap = tsp.shard_capacity(N, k)
    tw = Twin(k, cap, layout_kw(layout), max_batch=min(BATCH, cap), faults=faults,
              journal_limit=journal_limit, max_retries=max_retries, **skw)
    return tw, pts


def stream_in(tw, pts, k=K, batch=BATCH):
    for shard, chunk in tsp.stream_batches(pts, k, batch):
        tw.ingest(shard, chunk)
        tw.refresh()


def arm(tw, *events, **kw):
    tw.t.faults, tw.j.faults = plans(*events, **kw)


def assert_bitexact(faulted, twin):
    """Post-recovery contract: labels AND the cached pair-d2 matrix equal
    the uninterrupted twin's."""
    eq(faulted.pair_d2, twin.pair_d2, "pair_d2")
    fp, _, fl = faulted.live()
    tp, _, tl = twin.live()
    eq(fp, tp, "live points")
    eq(fl, tl, "live labels")


def fault_free(batch=BATCH, **kw):
    """The port's engine without faults, fed as ``stream_in`` feeds."""
    tw, pts = build(**kw)
    svc = tw.t
    for shard, chunk in tsp.stream_batches(pts, K, batch):
        svc.ingest(shard, chunk)
        svc.refresh()
    return svc, pts


# -- the failure model --------------------------------------------------------

@pytest.mark.parametrize("kind", ["poison", "corrupt"])
def test_bad_delta_rejected_before_pair_d2(kind):
    tw, pts = build()
    stream_in(tw, pts)
    before = tw.t.pair_d2
    arm(tw, (kind, 1), seed=3)
    tw.ingest(1, pts[:16])
    tw.refresh()
    assert 1 in tw.t.quarantined and "rejected" in tw.t.quarantined[1]
    eq(tw.t.pair_d2, before)


def test_healthy_shards_keep_serving_degraded():
    tw, pts = build()
    stream_in(tw, pts)
    arm(tw, ("poison", 1))
    tw.ingest(1, pts[:16])
    tw.refresh()
    (labels, stale), (jl, jstale) = tw.both("query", pts[:64], return_stale=True)
    eq(labels.labels, jl.labels)
    assert stale and jstale and labels.degraded
    assert tw.t.last_query_degraded and tw.t.degraded_queries == 1
    assert tw.t.stats()["quarantined_now"] == [1] == tw.j.stats()["quarantined_now"]
    check(tw.t, tw.j)


def test_transient_drop_heals_by_retry(monkeypatch):
    sleeps = []    # both engines' backoff (they share the time module)
    monkeypatch.setattr(tcs.time, "sleep", sleeps.append)
    tw, pts = build(retry_backoff=0.25)
    twin, _ = fault_free(retry_backoff=0.25)
    stream_in(tw, pts)
    arm(tw, ("drop", 0, None, 1))
    tw.ingest(0, pts[:32])
    tw.refresh()
    twin.ingest(0, pts[:32])
    twin.refresh()
    assert tw.t.retries == 1 and not tw.t.quarantined
    assert sleeps == [0.25, 0.25]
    assert_bitexact(tw.t, twin)


def test_exhausted_drop_quarantines(monkeypatch):
    sleeps = []    # both engines' backoff (they share the time module)
    monkeypatch.setattr(tcs.time, "sleep", sleeps.append)
    tw, pts = build(max_retries=2, retry_backoff=0.5)
    stream_in(tw, pts)
    arm(tw, ("drop", 2, None, 5))
    tw.ingest(2, pts[:32])
    tw.refresh()
    assert "dropped (3 attempts)" in tw.t.quarantined[2]
    assert tw.t.retries == 2 and sleeps == [0.5, 1.0, 0.5, 1.0]


def test_duplicate_delivery_is_fenced():
    tw, pts = build()
    twin, _ = fault_free()
    stream_in(tw, pts)
    arm(tw, ("dup", 3))
    tw.ingest(3, pts[:32])
    tw.refresh()
    twin.ingest(3, pts[:32])
    twin.refresh()
    assert tw.t.fenced_deltas == 1 and not tw.t.quarantined
    assert_bitexact(tw.t, twin)


def test_kill_recover_bitexact():
    tw, pts = build()
    twin, _ = fault_free()
    stream_in(tw, pts)
    arm(tw, ("kill", 1))
    for svc in (tw, twin):
        svc.ingest(1, pts[:32])
        svc.refresh()
    assert 1 in tw.t.quarantined
    assert not tw.t._mask[1].any()                # the lane's buffers are gone
    for svc in (tw, twin):
        svc.ingest(1, pts[32:64])
        svc.ingest(0, pts[64:96])
        svc.refresh()
    assert 1 in tw.t.quarantined
    got, want = tw.both("recover", 1)
    assert got and want
    tw.refresh()
    assert not tw.t.quarantined
    assert_bitexact(tw.t, twin)
    assert tw.both("recover", 1) == (False, False)


def test_recovery_with_journal_compaction():
    """Lane 0 dies at its first delivery and stays out while a tiny
    journal_limit compacts its log; replay from the compacted base must
    land bit for bit."""
    tw, pts = build(faults=plans(("kill", 0)), journal_limit=2)
    twin, _ = fault_free(batch=40, journal_limit=2)
    stream_in(tw, pts, batch=40)
    assert tw.t._journal.compactions > 0 and 0 in tw.t.quarantined
    tw.evict("evict_oldest", 0, 8)                # kill entries journal too
    twin.evict_oldest(0, 8)
    for svc in (tw, twin):
        svc.ingest(0, pts[:32])
        svc.refresh()
    assert 0 in tw.t.quarantined
    assert tw.both("recover_all") == ([0], [0])
    tw.refresh()
    assert_bitexact(tw.t, twin)


def test_quarantine_survives_snapshot():
    tw, pts = build()
    twin, _ = fault_free()
    stream_in(tw, pts)
    arm(tw, ("kill", 2))
    for svc in (tw, twin):
        svc.ingest(2, pts[:32])
        svc.refresh()
    (ta, tm), (ja, jm) = tw.t.state_dict(), tw.j.state_dict()
    for key in ja:
        eq(ta[key], ja[key], key)
    assert tm == jm
    # Each package restores the other's faulted state.
    back = Twin.__new__(Twin)
    back.refreshes = 0
    back.t = tcs.ClusterService.from_state(tw.t.scfg, ja, jm, device="cpu")
    back.j = jcs.ClusterService.from_state(tw.j.scfg, ta, tm)
    assert 2 in back.t.quarantined
    assert back.t.quarantine_events == tw.t.quarantine_events
    assert back.both("recover", 2) == (True, True)
    back.refresh()
    assert_bitexact(back.t, twin)


def test_diverged_replay_refuses_to_rejoin():
    tw, pts = build(faults=plans(("kill", 1)))
    stream_in(tw, pts)
    assert 1 in tw.t.quarantined
    for svc in (tw.t, tw.j):
        svc._hpts[1][0] += 1.0                     # the mirror no longer matches
    msgs = []
    for svc, err in ((tw.t, tfaults.RecoveryError), (tw.j, jfaults.RecoveryError)):
        with pytest.raises(err, match="diverged") as e:
            svc.recover(1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and 1 in tw.t.quarantined


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_plans_equal_reference(seed):
    """``FaultPlan.random`` plans over every kind: the faulted engines
    agree after every refresh, then recover to the fault-free twin."""
    kw = dict(seed=seed, shards=K, n_faults=4, horizon=3)
    tw, pts = build(faults=(tfaults.FaultPlan.random(**kw), jfaults.FaultPlan.random(**kw)),
                    max_retries=1)
    twin, _ = fault_free(max_retries=1)
    stream_in(tw, pts)
    tw.query(pts[::5])
    assert tw.t.quarantine_events > 0
    for _ in range(4):                        # a rejoined shard may meet a later event
        if not tw.t.quarantined:
            break
        got, want = tw.both("recover_all")
        assert got == want
        tw.refresh()
    assert not tw.t.quarantined
    assert_bitexact(tw.t, twin)
    got, want = tw.t.stats(), tw.j.stats()
    got.pop("jit_cache_entries"), want.pop("jit_cache_entries")   # process-wide
    assert got == want


# -- the query tier over the engine -------------------------------------------

def streamed(layout="rings", k=K):
    tw, pts = build(layout, k)
    stream_in(tw, pts, k)
    return tw, pts


def tiers(tw, **kw):
    return (tqt.QueryTier(tw.t, **kw), jqt.QueryTier(tw.j, **kw))


def test_snapshot_read_equals_sync_and_reference():
    tw, pts = streamed()
    tt, jt = tiers(tw, max_staleness=float("inf"))
    rng = np.random.default_rng(0)
    q = np.concatenate([pts[rng.integers(0, len(pts), 100)],
                        rng.uniform(0, 1, (40, 2)).astype(np.float32)])
    got, want = tt.query(q), jt.query(q)
    eq(got.labels, want.labels)
    assert got.version == tw.t.snapshot().version == want.version
    eq(got.labels, tw.t.query(q, legacy=True))
    assert tt.counters() == jt.counters()


def test_stale_snapshot_serves_pre_write_state():
    """Writes without a refresh never move the published view: the held
    snapshot's tensors are copies, not the rings written in place."""
    tw, pts = streamed()
    tt, jt = tiers(tw, max_staleness=float("inf"))
    q = pts[:64]
    before = tt.query(q).labels.copy()
    snap = tw.t.snapshot()
    held = [t.clone() for t in (snap.pts, snap.mask, snap.glabels)]
    v = snap.version
    tw.ingest(0, np.full((8, 2), 0.503, np.float32))        # dirty, unpublished
    tw.evict("evict_oldest", 1, 20)
    for got, want in zip((snap.pts, snap.mask, snap.glabels), held):
        eq(got, want)
    res = tt.query(q)
    assert res.version == v == jt.query(q).version
    eq(res.labels, before)
    tw.refresh()
    for got, want in zip((snap.pts, snap.mask, snap.glabels), held):
        eq(got, want)                                  # still the old view
    assert tt.query(q).version == v + 1 == jt.query(q).version


def test_fresh_policy_folds_pending_writes():
    tw, pts = streamed()
    tt, jt = tiers(tw, max_staleness=None)
    v = tw.t.snapshot().version
    tw.ingest(0, pts[:4])
    got, want = tt.query(pts[:16]), jt.query(pts[:16])
    assert got.version == v + 1 == want.version
    eq(got.labels, want.labels)
    check(tw.t, tw.j)


def test_restore_republishes_and_version_continues():
    tw, pts = streamed()
    v = tw.t.snapshot().version
    arrays, manifest = tw.t.state_dict()
    restored = tcs.ClusterService.from_state(tw.t.scfg, arrays, manifest, device="cpu")
    jrestored = jcs.ClusterService.from_state(tw.j.scfg, *tw.j.state_dict())
    assert restored.snapshot().version == v + 1 == jrestored.snapshot().version
    res = tqt.QueryTier(restored, max_staleness=float("inf")).query(pts[:32])
    eq(res.labels, tw.t.query(pts[:32], legacy=True))


def test_stale_quarantine_serves_last_good_rows():
    tw, pts = streamed()
    tt, jt = tiers(tw, max_staleness=float("inf"))
    q = pts[:64]
    healthy = tt.query(q)
    target = healthy.scanned_shards[0]
    for svc in (tw.t, tw.j):
        svc._quarantine(target, "chaos drill")
    stale, jstale = tt.query(q), jt.query(q)
    assert stale.degraded and jstale.degraded and stale.version == healthy.version
    eq(stale.labels, healthy.labels)
    eq(stale.labels, jstale.labels)


def test_publish_time_quarantine_routes_around_like_sync():
    tw, pts = streamed()
    q = pts[:64]
    target = tw.query(q).scanned_shards[0]
    for svc in (tw.t, tw.j):
        svc._quarantine(target, "chaos drill")
    tw.refresh(force=True)
    tt, jt = tiers(tw, max_staleness=float("inf"))
    res = tt.query(q)
    assert res.degraded and target not in res.scanned_shards
    eq(res.labels, tw.query(q).labels)
    eq(res.labels, jt.query(q).labels)


# -- the facade's stream backend -----------------------------------------------

def facade_cfg(mod, layout="rings", **kw):
    return mod.DDCConfig(**layout_kw(layout), **kw)


def test_backend_is_registered():
    assert set(T.BACKENDS) == {"host", "jit", "stream"}
    assert set(T.UNPORTED) == {"dist"}
    assert type(T.DDC(facade_cfg(T, backend="stream"), device="cpu").backend).__name__ \
        == "StreamBackend"


@pytest.mark.parametrize("kw,word", [(dict(agg_degree=2, shards=4), "hierarchy"),
                                     (dict(track=True), "tracking")])
def test_facade_accepts_tree_and_tracking(kw, word):
    """``DDC`` builds a stream backend with the tree or the tracker, and
    its service holds it (``pair_d2`` None in tree mode)."""
    pts = tsp.PHASE2_LAYOUTS["rings"]["make"](512)
    model = T.DDC(facade_cfg(T, backend="stream", **kw).validate(), device="cpu").fit(pts)
    ref = J.DDC(facade_cfg(J, backend="stream", **kw).validate()).fit(pts)
    svc = model.backend.service
    if word == "hierarchy":
        assert svc.hierarchy is not None and svc.pair_d2 is None and svc.tracker is None
    else:
        assert svc.tracker is not None and svc.hierarchy is None
        assert dataclasses.asdict(model.tracks()) == dataclasses.asdict(ref.tracks())
    eq(model.labels_, ref.labels_)


def test_stream_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.DDC(facade_cfg(T, backend="stream"))


def test_host_equals_stream_through_fit():
    pts = tsp.PHASE2_LAYOUTS["rings"]["make"](2048)
    host = T.DDC(facade_cfg(T, backend="host", shards=2), device="cpu").fit(pts)
    model = T.DDC(facade_cfg(T, backend="stream", shards=2), device="cpu").fit(pts)
    ref = J.DDC(facade_cfg(J, backend="stream", shards=2)).fit(pts)
    assert tddc.same_clustering(host.labels_, model.labels_)
    eq(model.labels_, ref.labels_)
    eq(model.points_, ref.points_)
    assert [list(p) for p in model.backend.parts()] == [list(p) for p in ref.backend.parts()]
    got, want = model.comm_stats(), ref.comm_stats()
    got.pop("jit_cache_entries"), want.pop("jit_cache_entries")   # process-wide
    assert got == want
    with pytest.raises(T.ConfigError, match="tracking is disabled"):
        model.tracks()


def test_expire_and_partial_fit_equal_reference():
    pts = tsp.PHASE2_LAYOUTS["rings"]["make"](2048)
    models = [mod.DDC(facade_cfg(mod, backend="stream", shards=2, capacity=1024), **kw)
              for mod, kw in ((T, {"device": "cpu"}), (J, {}))]
    for i, (shard, chunk) in enumerate(tsp.stream_batches(pts, 2, 256)):
        for m in models:
            m.partial_fit(shard, chunk, t=float(i))
    got, want = (m.expire(t=4.0) for m in models)
    assert got == want == 4 * 256
    eq(models[0].labels_, models[1].labels_)
    eq(models[0].query(pts[::9]).labels, models[1].query(pts[::9]).labels)
    assert models[0].expire(t=0.0) == 0


def test_partial_fit_before_fit_needs_capacity():
    model = T.DDC(facade_cfg(T, backend="stream", shards=2), device="cpu")
    assert model.backend.read_snapshot() is None and model.backend.snapshot() is None
    assert model.stats().gauges.shards == 2
    with pytest.raises(T.ConfigError, match="explicit capacity"):
        model.partial_fit(0, np.zeros((4, 2), np.float32))
    with pytest.raises(T.ConfigError, match="TTL eviction needs a streaming backend"):
        T.DDC(facade_cfg(T, backend="host"), device="cpu").expire(1.0)


def test_fresh_service_queries_all_noise_without_refresh():
    model = T.DDC(facade_cfg(T, backend="stream", shards=2, capacity=256), device="cpu")
    res = model.query(np.array([[0.5, 0.5]], np.float32))
    assert res.version == 0 and res[0] == -1 and model.service.refreshes == 0
    model.partial_fit(0, tsp.PHASE2_LAYOUTS["rings"]["make"](256))
    assert model.query(np.array([[0.5, 0.5]], np.float32)).version == 1


@pytest.mark.parametrize("writer,reader", [(T, J), (J, T)])
def test_stream_snapshots_cross_packages(writer, reader, tmp_path):
    """Stream half, save in one package, load in the other, stream the
    rest in both: labels, answers, pair-d2 and counters equal to an
    uninterrupted run of the loading package."""
    pts = tsp.PHASE2_LAYOUTS["linked_ovals"]["make"](2048)
    batches = tsp.stream_batches(pts, 2, 128)
    half = len(batches) // 2

    def make(mod):
        cfg = facade_cfg(mod, "linked_ovals", backend="stream", shards=2, capacity=1024,
                         max_batch=128)
        return mod.DDC(cfg, device="cpu") if mod is T else mod.DDC(cfg)

    def load(mod, path):
        return mod.DDC.load(path, device="cpu") if mod is T else mod.DDC.load(path)

    first = make(writer)
    for shard, chunk in batches[:half]:
        first.partial_fit(shard, chunk)
    first.labels_
    path = str(tmp_path / "ckpt")
    first.save(path)
    resumed = load(reader, path)
    again = load(writer, path)
    eq(resumed.labels_, again.labels_)
    assert resumed.service.refreshes == first.service.refreshes
    assert resumed.stats().gauges.snapshot_version == again.stats().gauges.snapshot_version
    whole = make(reader)
    for shard, chunk in batches:
        whole.partial_fit(shard, chunk)
    for shard, chunk in batches[half:]:
        resumed.partial_fit(shard, chunk)
    eq(resumed.labels_, whole.labels_)
    eq(np.asarray(resumed.service.pair_d2), np.asarray(whole.service.pair_d2))
    eq(resumed.query(pts[::13]).labels, whole.query(pts[::13]).labels)


def test_restore_preserves_engine_counters(tmp_path):
    pts = tsp.PHASE2_LAYOUTS["rings"]["make"](2048)
    cfg = facade_cfg(T, backend="stream", shards=2, capacity=1024, max_batch=128)
    model = T.DDC(cfg, device="cpu")
    for shard, chunk in tsp.stream_batches(pts[:1024], 2, 128):
        model.partial_fit(shard, chunk)
    model.labels_
    model.query(pts[:16])
    model.save(str(tmp_path / "ckpt"))
    restored = T.DDC.load(str(tmp_path / "ckpt"), device="cpu")
    svc, rsvc = model.service, restored.service
    assert (rsvc.refreshes, rsvc.n_live(), rsvc._head, rsvc._count, rsvc.query_chunks) == \
        (svc.refreshes, svc.n_live(), svc._head, svc._count, svc.query_chunks)
    eq(rsvc.pair_d2, svc.pair_d2)
    before = rsvc.refreshes
    eq(restored.labels_, model.labels_)
    assert rsvc.refreshes == before                 # no pending work
    assert restored.stats().counters == dataclasses.replace(
        model.stats().counters, snapshots_published=svc._snapshot_version + 1)


def test_facade_stats_equal_reference():
    pts = tsp.PHASE2_LAYOUTS["rings"]["make"](512)
    models = [mod.DDC(facade_cfg(mod, backend="stream", shards=2, capacity=512), **kw)
              .fit(pts) for mod, kw in ((T, {"device": "cpu"}), (J, {}))]
    for m in models:
        m.query(pts[:16])
        m.query_tier.query(pts[16:48])
        m.partial_fit(0, pts[:4])
        m.query(pts[:16])
    got, want = (m.stats() for m in models)
    assert got.backend == want.backend == "stream"
    assert got.counters == tqt.ServiceCounters(**dataclasses.asdict(want.counters))
    g, w = dataclasses.asdict(got.gauges), dataclasses.asdict(want.gauges)
    g.pop("jit_cache_entries"), w.pop("jit_cache_entries")
    assert g == w
    assert got.comm == want.comm
    cs = models[0].comm_stats()
    assert cs["backend"] == "stream" and cs["snapshot_version"] == got.gauges.snapshot_version
