"""The port's device-resident ``dist`` engine
(``repro_torch.serve.dist_service``) against the port's ``stream`` engine
and the reference package's ``stream`` engine, in this process, on the
CPU (the reference's own ``dist`` engine needs one JAX device a shard and
runs in tests/test_torch_dist_oracle.py's subprocess).

A ``Trio`` drives the port's dist engine, the port's stream engine and
the reference's stream engine through the same calls; after every
refresh each port engine is compared with the reference's bit for bit
(tests/test_torch_stream.py's ``check``: global and dense labels, slot
maps, the stacked ClusterSets, pair-d2, mirrors, counters, the meter, the
published snapshot).  Each case runs at K in {2, 4}:

- streaming, a forced full re-merge and queries (the sync fold on ties,
  and the lane query's distance against the jitted reference lane
  query on a one-lane mesh);
- the meter: |dirty|·B + K·C·4 a delta refresh, K·B + K·C·4 a full
  re-merge, one collective each way, as the reference's stream meter;
- ``state_dict`` across both engines and both packages;
- drops past ``max_retries``, a killed lane, quarantine, routing around
  it and recovery to the fault-free engine;
- the tree of aggregators and tracking on dist;
- tests/test_dist_backend.py's shard-range cases on dist;
- ``pytree_wire_bytes_int8``, the facade's dist backend, and the device
  rule (an accepted deviation: one device holds any number of lanes).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.ddc as J  # noqa: E402
import repro_torch.ddc as T  # noqa: E402
from repro.core import ddc as jddc  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.parallel import compress as jcompress  # noqa: E402
from repro.serve import cluster_service as jcs  # noqa: E402
from repro.serve import dist_service as jds  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import tracking as jtrk  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.parallel import compress as tcompress  # noqa: E402
from repro_torch.serve import cluster_service as tcs  # noqa: E402
from repro_torch.serve import dist_service as tds  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve import tracking as ttrk  # noqa: E402
from test_torch_stream import Twin, check, eq, layout_kw, swapped_ties  # noqa: E402

N = 1024
BATCH = 128
KS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class View:
    """A dist engine as ``check`` reads an engine: its per-lane buffers
    stacked (K, …)."""

    def __init__(self, svc):
        self.svc = svc

    def __getattr__(self, name):
        if name in tds.LANE_BUFFERS:
            return self.svc.stacked(name)
        return getattr(self.svc, name)


class Trio(Twin):
    """``Twin``'s engines (``t`` the port's stream engine, ``j`` the
    reference's) plus the port's dist engine ``d``, driven by the same
    calls; ``refresh`` compares both port engines with the reference.
    With ``meters=False`` no engine meters (a faulted dist engine meters
    the bytes it fetched, which the stream model does not count)."""

    def __init__(self, k, cap, ddc_kw, max_batch=BATCH, faults=(None, None, None),
                 meters=True, **skw):
        super().__init__(k, cap, ddc_kw, max_batch=max_batch, faults=faults[:2], **skw)
        self.d = tds.DistClusterService(self.t.scfg, meter=tddc.CommMeter(),
                                        faults=faults[2], device="cpu")
        if not meters:
            for svc in (self.t, self.j, self.d):
                svc.meter = None

    def both(self, name, *args, **kw):
        self.dist_out = getattr(self.d, name)(*args, **kw)
        return super().both(name, *args, **kw)

    def evict(self, name, *args):
        got = super().evict(name, *args)
        assert self.dist_out == got
        return got

    def refresh(self, **kw):
        super().refresh(**kw)
        check(View(self.d), self.j)

    def query(self, q, **kw):
        got = super().query(q, **kw)
        d = self.dist_out
        eq(d.labels, got.labels, "dist query labels")
        assert (d.version, d.degraded, d.scanned_shards) == \
            (got.version, got.degraded, got.scanned_shards)
        return got


def build(layout, k, n=N, faults=(None, None, None), meters=True, **kw):
    pts = tsp.PHASE2_LAYOUTS[layout]["make"](n)
    cap = tsp.shard_capacity(n, k)
    return Trio(k, cap, layout_kw(layout), max_batch=min(BATCH, cap), faults=faults,
                meters=meters, **kw), pts


def stream(tr, pts, k, batch=BATCH):
    for shard, chunk in tsp.stream_batches(pts, k, batch):
        tr.ingest(shard, chunk)
        tr.refresh()


def plans(*events, **kw):
    """One FaultPlan per engine (a plan counts deliveries): port stream,
    reference, port dist."""
    make = (lambda m: m.FaultPlan(events=tuple(m.FaultEvent(*e) for e in events), **kw))
    return make(tfaults), make(jfaults), make(tfaults)


def arm(tr, *events, **kw):
    tr.t.faults, tr.j.faults, tr.d.faults = plans(*events, **kw)


# -- streaming, the meter, queries ----------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("layout", ["rings", "noise_heavy"])
def test_dist_equals_stream_and_reference(layout, k):
    tr, pts = build(layout, k)
    stream(tr, pts, k)
    assert tr.d.delta_refreshes == tr.j.delta_refreshes > 0
    d2, labels = tr.d.pair_d2, tr.d.stacked("_glabels")
    tr.both("remerge_full")
    check(View(tr.d), tr.j)
    eq(tr.d.pair_d2, d2, "delta == full re-merge")
    eq(tr.d.stacked("_glabels"), labels)
    tr.query(np.concatenate([pts[::3], pts[::7] + 0.004,
                             np.array([[5.0, 5.0]], np.float32)]).astype(np.float32))


@pytest.mark.parametrize("k", KS)
def test_meter_counts_fetched_bytes(k):
    tr, pts = build("linked_ovals", k)
    stream(tr, pts, k)
    b, c = tr.d.cfg.buffer_bytes(), tr.d.cfg.max_clusters
    for svc in (tr.t, tr.j, tr.d):
        svc.meter.reset()
    tr.ingest(0, pts[:8])
    tr.refresh()
    assert tr.d.meter.snapshot()["bytes_total"] == b + k * c * 4
    assert tr.d.meter.snapshot()["collectives"] == 2
    for svc in (tr.t, tr.j, tr.d):
        svc.meter.reset()
    tr.both("remerge_full")
    check(View(tr.d), tr.j)
    assert tr.d.meter.snapshot()["bytes_total"] == k * b + k * c * 4
    before = tr.d.meter.snapshot()
    tr.refresh()                                  # nothing dirty: nothing crosses
    assert tr.d.meter.snapshot() == before
    tr.ingest(0, pts[:8])
    tr.ingest(k - 1, pts[8:16])
    tr.refresh()
    assert tr.d.meter.snapshot()["bytes_total"] == \
        before["bytes_total"] + 2 * b + k * c * 4


def reference_lane_query(q, pts, mask, glab, qmax):
    """The reference dist engine's jitted lane query on a one-lane mesh
    (its ``_data_plane``), scanned."""
    cfg = jddc.DDCConfig()
    fns = jds._data_plane(jmesh.make_host_mesh(1, axis=jds.AXIS), cfg, pts.shape[0], 8, qmax)
    bd, bl = fns["query"](jnp.asarray(q), jnp.asarray(pts[None]), jnp.asarray(mask[None]),
                          jnp.asarray(glab[None]), jnp.asarray(np.array([True])))
    return np.asarray(bd)[0], np.asarray(bl)[0]


@pytest.mark.parametrize("k", KS)
def test_lane_query_and_fold_equal_reference_on_ties(k):
    """FMA-decided ties split over ``k`` lanes: each lane's (best d2,
    label) equals the reference's jitted lane query bit for bit, and the
    ascending strict-``<`` fold equals both packages' flat argmin query,
    while the FMA-free distance would pick the other point in some rows."""
    q, pts, mask, glab = swapped_ties()
    n = pts.shape[1]
    lanes = np.array_split(np.arange(n), k)
    cap = max(len(ix) for ix in lanes)
    best, lab = [], []
    for ix in lanes:
        lp = np.zeros((cap, 2), np.float32)
        lm = np.zeros((cap,), bool)
        lg = np.full((cap,), -1, np.int32)
        lp[:len(ix)], lm[:len(ix)], lg[:len(ix)] = pts[0][ix], True, glab[0][ix]
        b, lb = tds.lane_best(torch.tensor(q), torch.tensor(lp), torch.tensor(lm),
                              torch.tensor(lg))
        jb, jl = reference_lane_query(q, lp, lm, lg, len(q))
        eq(b, jb, "lane best d2")
        eq(lb, jl, "lane label")
        best.append(b.numpy())
        lab.append(lb.numpy())
    got = tds.fold_lanes(np.stack(best), np.stack(lab), 0.05)
    want = np.asarray(jcs._query_labels(jnp.asarray(q), len(q), jnp.asarray(pts),
                                        jnp.asarray(mask), jnp.asarray(glab), 0.05))
    eq(got, want)
    eq(tcs._query_labels(torch.tensor(q), len(q), torch.tensor(pts), torch.tensor(mask),
                         torch.tensor(glab), 0.05).numpy(), want)
    diff = q[:, None, :] - pts[0][None]
    free = glab[0][np.argmin(diff[..., 0] ** 2 + diff[..., 1] ** 2, axis=1)]
    assert 0 < int((free != want).sum()) < len(q)


def test_lane_query_equals_reference_on_random_points():
    """256 queries against one lane of 4,096 points: every best d2 and label
    equals the reference's jitted lane query, which computes fma(dy, dy,
    dx·dx) (the FMA-free minimum differs in some rows)."""
    rng = np.random.default_rng(21)
    q = rng.uniform(0, 1, (256, 2)).astype(np.float32)
    pts = rng.uniform(0, 1, (4096, 2)).astype(np.float32)
    mask = rng.random(4096) > 0.2
    glab = rng.integers(-1, 9, 4096).astype(np.int32)
    b, lb = tds.lane_best(*(torch.tensor(x) for x in (q, pts, mask, glab)))
    jb, jl = reference_lane_query(q, pts, mask, glab, 256)
    eq(b, jb, "best d2")
    eq(lb, jl, "labels")
    d = q[:, None, :] - pts[None]
    free = np.where(mask & (glab >= 0), d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1],
                    np.float32(1e30)).min(axis=1)
    assert 0 < int((free != jb).sum()) < 256


def test_lane_query_with_nothing_clustered_is_the_identity():
    q = np.random.default_rng(0).uniform(0, 1, (16, 2)).astype(np.float32)
    pts = np.random.default_rng(1).uniform(0, 1, (64, 2)).astype(np.float32)
    mask = np.ones(64, bool)
    glab = np.full(64, -1, np.int32)
    b, lb = tds.lane_best(*(torch.tensor(x) for x in (q, pts, mask, glab)))
    jb, jl = reference_lane_query(q, pts, mask, glab, 16)
    eq(b, jb)
    eq(lb, jl)
    assert (b.numpy() == np.float32(1e30)).all()
    assert (tds.fold_lanes(b.numpy()[None], lb.numpy()[None], 1.0) == -1).all()


@pytest.mark.parametrize("k", KS)
def test_queries_equal_reference(k):
    tr, pts = build("rings", k)
    empty = tr.query(pts[:4])                     # empty engines: version 0
    assert empty.version == 0 and (empty.labels == -1).all()
    stream(tr, pts, k)
    live, _, labels = tr.d.live()
    got = tr.query(live[:300])
    clustered = labels[:300] >= 0
    np.testing.assert_array_equal(got.labels[clustered], labels[:300][clustered])
    far = tr.query(np.array([[5.0, 5.0], [-3.0, 7.0]], np.float32))
    assert (far.labels == -1).all() and far.scanned_shards == ()
    many = np.random.default_rng(k).uniform(0, 1, (600, 2)).astype(np.float32)
    tr.query(many)                                # three chunks of max_queries
    tr.ingest(1, pts[:32])                        # left dirty: the query refreshes
    tr.query(pts[:8])
    check(View(tr.d), tr.j)
    for legacy, stale in ((True, False), (False, True)):
        d = tr.d.query(pts[:8], legacy=legacy, return_stale=stale)
        s = tr.t.query(pts[:8], legacy=legacy, return_stale=stale)
        if stale:
            assert d[1] == s[1]
            d, s = d[0], s[0]
        eq(np.asarray(d), np.asarray(s))


# -- snapshots -------------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
def test_state_dict_round_trips_across_engines_and_packages(k):
    tr, pts = build("linked_ovals", k)
    stream(tr, pts[:768], k)
    tr.ingest(1, pts[768:800])                    # a dirty shard in the state
    states = {"dist": tr.d.state_dict(), "stream": tr.t.state_dict(),
              "reference": tr.j.state_dict()}
    (ra, rm) = states["reference"]
    for name in ("dist", "stream"):
        a, m = states[name]
        assert sorted(a) == sorted(ra) and m == rm, name
        for key in ra:
            eq(a[key], ra[key], f"{name} {key}")
    # Every engine restores every engine's state (a copy each: the
    # reference's restore keeps and writes the mirror arrays it is given);
    # the restored trios carry on equal through another round.
    for src in states:
        a, m = states[src]
        a = {key: np.array(v, copy=True) for key, v in a.items()}
        back = Trio.__new__(Trio)
        back.refreshes = 0
        back.t = tcs.ClusterService.from_state(tr.t.scfg, a, m, meter=tddc.CommMeter(),
                                               device="cpu")
        back.j = jcs.ClusterService.from_state(tr.j.scfg, a, m, meter=jddc.CommMeter())
        back.d = tds.DistClusterService.from_state(tr.t.scfg, a, m, meter=tddc.CommMeter(),
                                                   device="cpu")
        check(View(back.d), back.j)
        assert back.d._snapshot_version == tr.d._snapshot_version + 1
        back.refresh()
        back.ingest(2 % k, pts[800:900])
        back.refresh()
        back.query(pts[::9])
    da, dm = tr.d.state_dict()
    assert dm == rm and all(np.array_equal(da[key], ra[key]) for key in ra)


# -- faults ------------------------------------------------------------------------

def fault_free(layout, k):
    svc = tds.DistClusterService(
        tcs.StreamConfig(shards=k, capacity=tsp.shard_capacity(N, k),
                         max_batch=min(BATCH, tsp.shard_capacity(N, k)),
                         ddc=tddc.DDCConfig(**layout_kw(layout))), device="cpu")
    pts = tsp.PHASE2_LAYOUTS[layout]["make"](N)
    for shard, chunk in tsp.stream_batches(pts, k, BATCH):
        svc.ingest(shard, chunk)
        svc.refresh()
    return svc


def assert_bitexact(faulted, twin):
    eq(faulted.pair_d2, twin.pair_d2, "pair_d2")
    fp, _, fl = faulted.live()
    tp, _, tl = twin.live()
    eq(fp, tp, "live points")
    eq(fl, tl, "live labels")


@pytest.mark.parametrize("k", KS)
def test_drop_quarantine_routing_and_recovery(k):
    """Shard 1's delta dropped past ``max_retries`` (and, at K 4, shard 3's
    lane killed): quarantine, a degraded query routed around it, the
    journal's recovery, then the fault-free dist engine bit for bit."""
    tr, pts = build("rings", k, meters=False, max_retries=1)
    twin = fault_free("rings", k)
    stream(tr, pts, k)
    events = [("drop", 1, None, 3)] + ([("kill", 3)] if k > 2 else [])
    arm(tr, *events)
    extra = pts[:48]
    for shard in sorted({e[1] for e in events}):
        tr.ingest(shard, extra)
        twin.ingest(shard, extra)
    tr.refresh()
    twin.refresh()
    assert sorted(tr.d.quarantined) == sorted({e[1] for e in events})
    assert "dropped (2 attempts)" in tr.d.quarantined[1]
    assert tr.d.retries == tr.j.retries == 1
    if k > 2:
        assert not tr.d._mask[3].any()            # the killed lane's buffers are gone
    near = tr.d._hpts[1][tr.d._live[1]][:32]
    res = tr.query(near)
    assert res.degraded and 1 not in res.scanned_shards
    for svc in (tr.t, tr.j, tr.d):
        svc.faults = None                         # the link heals
    got, want = tr.both("recover_all")
    assert got == want == tr.dist_out
    tr.refresh()
    assert not tr.d.quarantined
    assert_bitexact(tr.d, twin)
    tr.query(pts[::11])


@pytest.mark.parametrize("kind", ["poison", "dup"])
def test_rejected_and_duplicate_deltas(kind):
    tr, pts = build("rings", 2, meters=False)
    stream(tr, pts, 2)
    before = tr.d.pair_d2
    arm(tr, (kind, 1), seed=3)
    tr.ingest(1, pts[:16])
    tr.refresh()
    if kind == "poison":
        assert "rejected" in tr.d.quarantined[1]
        eq(tr.d.pair_d2, before)
    else:
        assert tr.d.fenced_deltas == 1 and not tr.d.quarantined


# -- the tree and tracking on dist ------------------------------------------------

@pytest.mark.parametrize("k", KS)
def test_tree_on_dist_equals_reference(k):
    tr, pts = build("linked_ovals", k, agg_degree=2)
    assert tr.d.hierarchy is not None and tr.d.pair_d2 is None
    stream(tr, pts, k)
    tr.ingest(0, pts[:64])
    tr.refresh()
    tr.both("remerge_full")
    check(View(tr.d), tr.j)
    for svc in (tr.t, tr.j, tr.d):
        svc.meter.reset()
    tr.ingest(k - 1, pts[64:96])
    tr.refresh()
    assert tr.d.hierarchy.last_stats == tr.j.hierarchy.last_stats
    tr.query(pts[::13])


@pytest.mark.parametrize("k", KS)
def test_tracking_on_dist_equals_reference(k):
    spec = tsp.TRAJECTORY_LAYOUTS["drifting_blobs"]
    traj = spec["make"](steps=8, n_per_step=spec["n_per_step"])
    cap = tsp.trajectory_capacity(spec["n_per_step"], spec["window"], k)
    kw = dict(eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
              max_clusters=spec["max_clusters"], max_verts=spec["max_verts"],
              shards=k, capacity=cap, max_batch=min(256, cap), track=True)
    dist = T.DDC(T.DDCConfig(backend="dist", **kw).validate(), device="cpu")
    ref = J.DDC(J.DDCConfig(backend="stream", **kw).validate())
    got = ttrk.play(dist, traj.frames, window=spec["window"])
    want = jtrk.play(ref, traj.frames, window=spec["window"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    (ga, gm), (wa, wm) = dist.service.tracker.state_dict(), ref.service.tracker.state_dict()
    assert gm == wm and sorted(ga) == sorted(wa)
    for key in wa:
        eq(np.asarray(ga[key]), np.asarray(wa[key]), key)
    assert got.births > 0


# -- tests/test_dist_backend.py's shard-range cases, on dist -----------------------

def make_dist(shards=2):
    return tds.DistClusterService(tcs.StreamConfig(
        shards=shards, capacity=64, max_batch=64,
        ddc=tddc.DDCConfig(**layout_kw("rings"))), device="cpu")


@pytest.mark.parametrize("shard", (-1, 2, 99))
def test_ingest_rejects_out_of_range(shard):
    with pytest.raises(ValueError, match="out of range"):
        make_dist().ingest(shard, np.zeros((4, 2), np.float32))


@pytest.mark.parametrize("method,args", [("evict_oldest", (5,)), ("evict_older_than", (0.0,)),
                                         ("clear", ()), ("local_set", ()),
                                         ("shard_bbox", ())])
@pytest.mark.parametrize("shard", (-1, 2))
def test_evict_entry_points_reject_out_of_range(method, args, shard):
    with pytest.raises(ValueError, match="out of range"):
        getattr(make_dist(), method)(shard, *args)


def test_out_of_range_leaves_state_untouched():
    svc = make_dist()
    svc.ingest(0, np.full((4, 2), 0.5, np.float32))
    before = svc.n_live()
    for call in (lambda: svc.ingest(7, np.zeros((2, 2))), lambda: svc.evict_oldest(-3, 1),
                 lambda: svc.clear(2)):
        with pytest.raises(ValueError):
            call()
    assert svc.n_live() == before


def test_facade_partial_fit_rejects_out_of_range():
    model = T.DDC(T.DDCConfig(backend="dist", shards=2, capacity=64, max_batch=64),
                  device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        model.partial_fit(9, np.zeros((4, 2), np.float32))


# -- the wire size, the facade, the device rule ------------------------------------

def test_pytree_wire_bytes_int8_equals_reference():
    pts = tsp.PHASE2_LAYOUTS["rings"]["make"](512)
    cfg = tddc.DDCConfig(**layout_kw("rings"))
    _, cs = tddc.local_phase(torch.tensor(pts), torch.ones(512, dtype=torch.bool), cfg)
    host = {f: t.numpy() for f, t in zip(tddc.ClusterSet._fields, cs)}
    trees = [cs, host, jddc.ClusterSet(**host), {"a": np.zeros((3, 5), np.float16),
             "b": np.zeros((7,), np.int64), "c": 1.5, "d": (np.zeros((), np.float32),
             np.ones((2, 2), bool))}]
    for tree in trees:
        ref_tree = host if tree is cs else tree
        want = jcompress.pytree_wire_bytes_int8(ref_tree)
        assert tcompress.pytree_wire_bytes_int8(tree) == want
        assert tcompress.pytree_wire_bytes(tree) == jcompress.pytree_wire_bytes(ref_tree)
    b = cfg.buffer_bytes()
    v, c = cfg.max_verts, cfg.max_clusters
    assert tcompress.pytree_wire_bytes_int8(cs) == b - c * v * 2 * 4 + c * v * 2 + 4 * c


def test_dist_backend_builds_and_equals_stream():
    pts = tsp.PHASE2_LAYOUTS["rings"]["make"](N)
    cfg = dict(layout_kw("rings"), shards=4)
    dist = T.DDC(T.DDCConfig(backend="dist", **cfg).validate(), device="cpu").fit(pts)
    strm = T.DDC(T.DDCConfig(backend="stream", **cfg).validate(), device="cpu").fit(pts)
    assert type(dist.backend).__name__ == "DistBackend"
    assert isinstance(dist.backend.service, tds.DistClusterService)
    eq(dist.labels_, strm.labels_)
    assert dist.comm_stats() == {**strm.comm_stats(), "backend": "dist"}
    assert dist.stats().backend == "dist"


def test_lanes_have_streams_only_on_a_card():
    lanes = tmesh.make_lane_mesh(3, "cpu")
    assert [lane.index for lane in lanes] == [0, 1, 2]
    assert all(lane.stream is None and lane.device.type == "cpu" for lane in lanes)
    t = torch.zeros(3)
    with lanes[1].scope():
        lanes[1].hold(t)
    tmesh.join(lanes, t)


def test_one_device_holds_every_lane_an_accepted_deviation():
    """The reference's dist engine needs one JAX device a shard, so its
    ``validate`` rejects shards=8 in this one-device process; the port's
    lanes are streams on one device, so it accepts the config and builds
    the engine."""
    with pytest.raises(J.ConfigError, match="xla_force_host_platform"):
        J.DDCConfig(backend="dist", shards=8).validate()
    cfg = T.DDCConfig(backend="dist", shards=8, capacity=256).validate()
    model = T.DDC(cfg, device="cpu")
    assert len(model.backend.service.lanes) == 8


def test_dist_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scfg = tcs.StreamConfig(shards=4, capacity=64, max_batch=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.DistClusterService(scfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.require_devices(4, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.DDC(T.DDCConfig(backend="dist", shards=4, capacity=64, max_batch=64))
    assert tds.require_devices(4, "cpu") == torch.device("cpu")
