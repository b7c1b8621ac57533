"""The port's query tier (``repro_torch.serve.query_tier``) against the
reference package's (``repro.serve.query_tier``), on the CPU.  Every
comparison is exact.

- ``_snapshot_query`` equals the reference's jitted one on the same
  inputs: ties that only the reference's FMA, fma(dy, dy, dx·dx), decides
  (the FMA-free dx² + dy² picks the other candidate in some of them, which
  a test shows), points exactly at eps and one float32 step beyond it,
  masked and negative-label rows, padded shards, and every pow2 query
  bucket.
- A tier over the same snapshot in both packages gives the same answers
  (labels, version, degraded flag, scanned shards) and the same counters
  on the same call sequence: coalescing, bucketing, out-of-bounds
  requests, quarantine at publish time and after it.  Routing
  (``bbox_route``, ``route_snapshot``) and ``pow2_bucket`` are copies and
  are held equal too.
- Through the facade (host and jit backends), ``ServiceStats`` has the
  reference's key sets and equal counters, gauges and comm counts on the
  same call sequence.  The one gauge left out is ``jit_cache_entries``:
  it is process-wide (the reference counts its jit cache, the port the
  launch shapes it has seen), so it depends on what else ran in the
  process; its bound (``cache_bound``) is tested on its own.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.ddc as J  # noqa: E402
import repro_torch.ddc as T  # noqa: E402
from repro.serve import query_tier as jqt  # noqa: E402
from repro_torch.data import spatial  # noqa: E402
from repro_torch.serve import query_tier as tqt  # noqa: E402

LAYOUT_FIELDS = ("eps", "min_pts", "grid", "max_verts", "max_clusters")


def both_queries(q, pts, mask, glab, eps):
    """(port, reference) labels of one snapshot query on the same inputs."""
    got = tqt._snapshot_query(torch.tensor(q), torch.tensor(pts), torch.tensor(mask),
                              torch.tensor(glab), eps).numpy()
    want = np.asarray(jqt._snapshot_query(jnp.asarray(q), jnp.asarray(pts),
                                          jnp.asarray(mask), jnp.asarray(glab), eps))
    assert got.dtype == np.int32
    return got, want


def swapped_ties(n: int = 256, seed: int = 0):
    """Per query q in [0.5, 1)², two stored points at q + (a, b) and
    q + (b, a), with a, b multiples of 2^-24 below 2^-7: every sum and
    difference is exact, so the FMA-free distances a² + b² and b² + a²
    tie bit for bit, while fma(b, b, a²) and fma(a, a, b²) may differ."""
    rng = np.random.default_rng(seed)
    q = (0.5 + rng.integers(0, 1 << 22, (n, 2)) * 2.0 ** -24).astype(np.float32)
    d = (rng.integers(1 << 15, 1 << 17, (n, 2)) * 2.0 ** -24).astype(np.float32)
    pts = np.empty((1, 2 * n, 2), np.float32)
    pts[0, 0::2] = q + d
    pts[0, 1::2] = q + d[:, ::-1]
    assert np.array_equal(pts[0, 0::2] - q, d) and np.array_equal(pts[0, 1::2] - q, d[:, ::-1])
    return q, pts, np.ones((1, 2 * n), bool), np.arange(2 * n, dtype=np.int32)[None]


def test_fma_decided_ties_equal_reference():
    q, pts, mask, glab = swapped_ties()
    got, want = both_queries(q, pts, mask, glab, 0.05)
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).all()


def test_fma_free_form_gets_ties_wrong():
    """The FMA-free form dx² + dy² ties on every case and keeps the first
    candidate; the reference's FMA picks the second in some of them, so a
    port written as ((q − p) ** 2).sum(-1) would give other labels."""
    q, pts, mask, glab = swapped_ties()
    _, want = both_queries(q, pts, mask, glab, 0.05)
    diff = q[:, None, :] - pts[0][None]
    free = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    assert (free[:, 0::2] == free[:, 1::2])[np.arange(len(q)), np.arange(len(q))].all()
    free_labels = glab[0][np.argmin(free, axis=1)]
    wrong = int((free_labels != want).sum())
    assert 0 < wrong < len(q), wrong


@pytest.mark.parametrize("eps", [0.25, 0.1, 0.03, 1e-3])
def test_point_at_eps_equals_reference(eps):
    """A stored point exactly eps away (eps the float32 difference of the
    two coordinates, which Sterbenz's lemma makes exact) is a hit, one
    float32 step farther is not, in both packages."""
    half = np.float32(0.5)
    at = half + np.float32(eps)
    eps = float(at - half)
    beyond = np.nextafter(at, np.float32(2))
    q = np.full((1, 2), half, np.float32)
    pts = np.array([[[at, half], [0.9, 0.9]],
                    [[half, at], [0.9, 0.9]],
                    [[beyond, half], [0.9, 0.9]],
                    [[half, beyond], [0.9, 0.9]]], np.float32).reshape(1, 8, 2)
    glab = np.arange(8, dtype=np.int32)[None]
    for i in range(4):
        m = np.zeros((1, 8), bool)
        m[0, 2 * i:2 * i + 2] = True
        got, want = both_queries(q, pts, m, glab, eps)
        np.testing.assert_array_equal(got, want)
        assert (want[0] >= 0) == (i < 2), (i, want)


def test_masked_and_noise_rows_equal_reference():
    """The nearest rows are masked out or labelled -1: both packages skip
    them the same way (the next clustered live row, or -1)."""
    rng = np.random.default_rng(3)
    k, cap = 4, 64
    pts = rng.uniform(0, 1, (k, cap, 2)).astype(np.float32)
    mask = rng.random((k, cap)) > 0.3
    glab = rng.integers(-1, 5, (k, cap)).astype(np.int32)
    q = np.concatenate([pts.reshape(-1, 2)[::3] + 1e-4,
                        rng.uniform(0, 1, (64, 2))]).astype(np.float32)
    for eps in (0.02, 0.2, 2.0):
        got, want = both_queries(q, pts, mask, glab, eps)
        np.testing.assert_array_equal(got, want)
    none = np.zeros_like(mask)
    got, want = both_queries(q, pts, none, glab, 2.0)
    np.testing.assert_array_equal(got, want)
    assert (want == -1).all()


def test_row_chunks_change_nothing(monkeypatch):
    """The query rows go in chunks of PAIR_CHUNK pair tests; a chunk of a
    single row gives the same labels."""
    q, pts, mask, glab = swapped_ties(64, seed=4)
    full, want = both_queries(q, pts, mask, glab, 0.05)
    monkeypatch.setattr(tqt, "PAIR_CHUNK", 1)
    one, _ = both_queries(q, pts, mask, glab, 0.05)
    np.testing.assert_array_equal(one, full)
    np.testing.assert_array_equal(one, want)


# -- a tier over the same snapshot in both packages ---------------------------


def snapshot_arrays(k=5, cap=64, seed=0, empty=(3,)):
    """Per-shard spatially separated rows (shard s in its own vertical
    strip), so routing scans a subset; shards in ``empty`` hold nothing."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((k, cap, 2), np.float32)
    mask = np.zeros((k, cap), bool)
    glab = np.full((k, cap), -1, np.int32)
    bboxes = []
    for s in range(k):
        if s in empty:
            bboxes.append(None)
            continue
        n = int(rng.integers(cap // 2, cap + 1))
        p = np.stack([s / k + rng.uniform(0, 1 / k, n), rng.uniform(0, 1, n)], 1)
        pts[s, :n] = p
        mask[s, :n] = True
        glab[s, :n] = rng.integers(-1, 3, n) + 3 * s
        bboxes.append((float(pts[s, :n, 0].min()), float(pts[s, :n, 1].min()),
                       float(pts[s, :n, 0].max()), float(pts[s, :n, 1].max())))
    return pts, mask, glab, tuple(bboxes)


class Source:
    """A snapshot source for either package's tier: one published view,
    optional shards quarantined after it."""

    def __init__(self, snap, quarantined_now=()):
        self.snap = snap
        self.quarantined = {s: "drill" for s in quarantined_now}

    def snapshot(self):
        return self.snap

    def read_snapshot(self):
        return self.snap


def twin_tiers(eps=0.04, quarantined=frozenset(), quarantined_now=(), **tier_kw):
    pts, mask, glab, bboxes = snapshot_arrays()
    common = dict(version=3, epoch=2, published_at=time.monotonic(), eps=eps, bboxes=bboxes,
                  quarantined=frozenset(quarantined), n_live=int(mask.sum()), n_clusters=9)
    tsnap = tqt.Snapshot(pts=torch.tensor(pts), mask=torch.tensor(mask),
                         glabels=torch.tensor(glab), **common)
    jsnap = jqt.Snapshot(pts=jnp.asarray(pts), mask=jnp.asarray(mask),
                         glabels=jnp.asarray(glab), **common)
    return (tqt.QueryTier(Source(tsnap, quarantined_now), **tier_kw),
            jqt.QueryTier(Source(jsnap, quarantined_now), **tier_kw))


def same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x).__module__ == "repro_torch.serve.query_tier"
        np.testing.assert_array_equal(x.labels, y.labels)
        assert x.labels.dtype == y.labels.dtype == np.int32
        assert (x.version, x.degraded, x.scanned_shards) == \
            (y.version, y.degraded, y.scanned_shards)


def requests(seed=1):
    rng = np.random.default_rng(seed)
    strip = [np.stack([s / 5 + rng.uniform(0, 0.2, 9), rng.uniform(0, 1, 9)], 1)
             for s in range(5)]
    return [strip[0], strip[1], strip[0] + 0.01, strip[4], np.array([[9.0, 9.0]]),
            rng.uniform(0, 1, (37, 2)), strip[2], strip[3]]


def drive(tier, reqs):
    for r in reqs:
        tier.submit(r)
    return tier.drain()


def test_coalesced_drain_equals_reference():
    tiers = twin_tiers()
    reqs = requests()
    got, want = (drive(t, reqs) for t in tiers)
    same_results(got, want)
    assert tiers[0].counters() == tiers[1].counters()
    assert tiers[0].query_launches < len(reqs)            # coalesced
    assert tiers[0].coalesced_requests > 0
    assert got[4].scanned_shards == () and got[4][0] == -1  # out of bounds: no launch


@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 32, 33, 64, 65, 128, 129, 255, 256, 257, 600])
def test_every_pow2_bucket_equals_reference(n):
    tiers = twin_tiers(max_queries=256, bucket_min=16, eps=0.08)
    q = np.random.default_rng(n).uniform(-0.05, 1.05, (n, 2)).astype(np.float32)
    got, want = (t.query(q) for t in tiers)
    same_results([got], [want])
    assert tiers[0].counters() == tiers[1].counters()
    rows = sum(tqt.pow2_bucket(min(256, n - off), 16, 256) for off in range(0, n, 256))
    assert tiers[0].query_rows == rows


@pytest.mark.parametrize("sel", [[0], [1, 2], [0, 2, 4], [0, 1, 2, 4], [0, 1, 2, 3, 4]])
def test_padded_shards_equal_reference(sel):
    """A scan set of 3 or 5 shards pads to 4 or 8 rows of shard 0 with the
    mask off: the gathered rows and the answers equal the reference's."""
    tiers = twin_tiers()
    snaps = [t.source.snapshot() for t in tiers]
    sel = np.asarray(sel)
    (tp, tm, tg), (jp, jm, jg) = (t._gather(s, sel) for t, s in zip(tiers, snaps))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tp.shape[0] == 1 << (len(sel) - 1).bit_length()
    q = np.random.default_rng(len(sel)).uniform(0, 1, (100, 2)).astype(np.float32)
    got, want = both_queries(q, tp.numpy(), tm.numpy(), tg.numpy(), 0.1)
    np.testing.assert_array_equal(got, want)


def test_quarantine_equals_reference():
    """Shard 1 quarantined at publish time (routed around) and shard 2
    after it (served stale): the same labels and degraded flags."""
    tiers = twin_tiers(quarantined={1}, quarantined_now=(1, 2))
    reqs = requests(2)
    got, want = (drive(t, reqs) for t in tiers)
    same_results(got, want)
    assert any(r.degraded for r in got) and not all(r.degraded for r in got)
    assert all(1 not in r.scanned_shards for r in got)
    assert tiers[0].degraded_queries == tiers[1].degraded_queries > 0


def test_routing_equals_reference():
    _, _, _, bboxes = snapshot_arrays()
    rng = np.random.default_rng(9)
    eps = 0.05
    for box in bboxes:
        if box is None:
            continue
        x0, y0, x1, y1 = box
        for d in (eps, eps * (1 + 5e-7), eps * (1 + 2e-6), 2 * eps):
            for q in ([[x1 + d, (y0 + y1) / 2]], [[(x0 + x1) / 2, y0 - d]], [[x0 - d, y1 + d]]):
                q = np.asarray(q)
                np.testing.assert_array_equal(tqt.bbox_route(bboxes, q, eps),
                                              jqt.bbox_route(bboxes, q, eps))
    q = rng.uniform(-0.2, 1.2, (50, 2))
    np.testing.assert_array_equal(tqt.bbox_route(bboxes, q, eps), jqt.bbox_route(bboxes, q, eps))
    assert tqt.routing_eps(0.25) == jqt.routing_eps(0.25)
    assert tqt.ROUTE_EPS_DILATION == jqt.ROUTE_EPS_DILATION
    for lo, hi in ((16, 256), (1, 8), (32, 32)):
        for n in range(0, 300, 7):
            assert tqt.pow2_bucket(n, lo, hi) == jqt.pow2_bucket(n, lo, hi)


def test_launch_shapes_bounded_by_pow2_buckets():
    """Any mix of request widths launches at most (#query buckets ×
    #shard-width buckets) distinct shapes."""
    k = 5
    tier, _ = twin_tiers(max_queries=256, bucket_min=16)
    tqt.clear_snapshot_query_cache()
    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 7, 15, 16, 17, 31, 40, 64, 100, 200, 256, 300):
        tier.query(rng.uniform(0, 1, (n, 2)).astype(np.float32))
        tier.query(rng.uniform(0, 0.2, (n, 2)).astype(np.float32))
    entries = tqt.snapshot_query_cache_entries()
    assert 1 < entries <= tier.cache_bound(k)
    assert tier.cache_bound(k) == tier.__class__.cache_bound(
        jqt.QueryTier(None, max_queries=256, bucket_min=16), k)
    tqt.clear_snapshot_query_cache()
    assert tqt.snapshot_query_cache_entries() == 0


def test_queue_full_and_deadlines():
    tier, ref = twin_tiers(queue_depth=3)
    for t in (tier, ref):
        for _ in range(3):
            t.submit(np.array([[0.1, 0.5]]))
    with pytest.raises(tqt.QueueFull, match="drain"):
        tier.submit(np.array([[0.1, 0.5]]))
    same_results(tier.drain(), ref.drain())
    past = time.monotonic() - 1.0
    handles = [t.submit(np.array([[0.3, 0.5]]), deadline=past) for t in (tier, ref)]
    for t in (tier, ref):
        t.drain()
    same_results([handles[0].result], [handles[1].result])
    assert tier.deadline_misses == ref.deadline_misses == 1
    assert tier.pending == 0


def test_empty_source_short_circuits_at_version_zero():
    tier = tqt.QueryTier(Source(None))
    res = tier.query(np.array([[0.5, 0.5], [0.2, 0.1]]))
    assert res.version == 0 and res.tolist() == [-1, -1]
    assert tier.query_launches == 0 and tier.queries_served == 1


# -- QueryResult and ServiceStats through the facade ---------------------------


def fitted(pkg, backend, shards=2, n=512, **kw):
    spec = spatial.PHASE2_LAYOUTS["rings"]
    cfg = pkg.DDCConfig(**{k: spec[k] for k in LAYOUT_FIELDS}, backend=backend, shards=shards,
                        **kw)
    model = pkg.DDC(cfg, device="cpu") if pkg is T else pkg.DDC(cfg)
    return model.fit(spec["make"](n)), spec["make"](n)


def test_query_result_duck_typing():
    model, pts = fitted(T, "host")
    res = model.query(pts[:16])
    assert isinstance(res, tqt.QueryResult) and res.version >= 1
    assert res.degraded is False and isinstance(res.scanned_shards, tuple)
    assert res.latency_ms >= 0.0 and "version" in repr(res)
    assert np.asarray(res).dtype == np.int32
    assert len(res) == 16 and res.shape == (16,) and list(res) == res.tolist()
    assert res[0] == res.labels[0]
    assert 0.0 <= float(np.mean(res >= 0)) <= 1.0
    np.testing.assert_array_equal(np.where(res >= 0, res.labels, -1), res.labels)
    np.testing.assert_array_equal(res < 0, res.labels < 0)
    np.testing.assert_array_equal(res != -1, res.labels != -1)
    assert hash(res) == object.__hash__(res) and {res: 1}[res] == 1
    bare = model.query(pts[:8], legacy=True)
    assert type(bare) is np.ndarray
    np.testing.assert_array_equal(bare, model.query(pts[:8]).labels)


def call_sequence(model, pts):
    """Queries, a coalesced drain, a write, more queries; the stats after
    each step."""
    out = []

    def stats():
        d = model.stats().as_dict()
        d.pop("jit_cache_entries")
        out.append((d, model.stats().backend))

    stats()
    model.query(pts[:32])
    stats()
    tier = model.query_tier
    for off in (0, 8, 16):
        tier.submit(pts[off:off + 8])
    tier.submit(np.array([[7.0, 7.0]]))
    tier.drain()
    stats()
    model.partial_fit(0, pts[:4])
    model.query(pts[:300])
    stats()
    comm = model.comm_stats()
    comm.pop("jit_cache_entries", None)
    out.append(comm)
    return out


@pytest.mark.parametrize("backend,shards,kw", [
    ("host", 2, {}), ("jit", 1, {}), ("host", 3, {"max_staleness": float("inf")}),
    ("jit", 1, {"query_bucket_min": 32, "max_queries": 64, "queue_depth": 8})])
def test_service_stats_equal_reference(backend, shards, kw):
    model, pts = fitted(T, backend, shards, **kw)
    ref, _ = fitted(J, backend, shards, **kw)
    got, want = call_sequence(model, pts), call_sequence(ref, pts)
    assert got == want
    stats = model.stats()
    assert isinstance(stats, tqt.ServiceStats)
    assert set(stats.as_dict()) == set(ref.stats().as_dict())
    assert set(stats.comm_dict()) == set(ref.stats().comm_dict())
    assert dataclasses.asdict(stats.counters) == dataclasses.asdict(ref.stats().counters)


def test_facade_tier_uses_config_knobs():
    model, _ = fitted(T, "host", queue_depth=5, query_bucket_min=32,
                      max_staleness=float("inf"))
    tier = model.query_tier
    assert (tier.queue_depth, tier.bucket_min, tier.max_staleness) == (5, 32, float("inf"))
    assert model.query_tier is tier


@pytest.mark.parametrize("backend,shards", [("host", 2), ("jit", 1)])
def test_repeated_queries_do_not_refit(backend, shards):
    model, pts = fitted(T, backend, shards)
    r1 = model.query(pts[:32])
    for _ in range(5):
        r2 = model.query(pts[:32])
    assert model.backend.refits == 1
    assert r1.version == r2.version == 1
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    labels = model.labels_
    got = model.query(pts)
    np.testing.assert_array_equal(np.asarray(got)[labels >= 0], labels[labels >= 0])
    model.partial_fit(0, pts[:4])
    assert model.query(pts[:8]).version == 2


def test_snapshot_tensors_are_copies_on_the_device():
    model, pts = fitted(T, "jit", 2)
    snap = model.backend.read_snapshot()
    assert snap.pts.device.type == "cpu" and snap.pts.dtype == torch.float32
    assert snap.mask.dtype == torch.bool and snap.glabels.dtype == torch.int32
    assert snap.pts.shape == (2, 256, 2)
    before = snap.pts.clone()
    model.partial_fit(1, pts[:10])
    model.query(pts[:4])
    assert model.backend.snapshot() is not snap
    assert torch.equal(snap.pts, before)
