"""The port's cluster tracking (``repro_torch.serve.tracking``) and
trajectory generators against the reference package's, on the CPU.

The reference promises (DESIGN.md §14) that tracking is a pure fold over
the per-generation (batch contours, slot maps, global sizes), so the
same frames give bit-identical tracker state on every topology and
across save → load → resume.  Here:

- the three trajectory generators, ``TRAJECTORY_LAYOUTS`` and
  ``trajectory_capacity`` equal the reference's, array for array;
- every in-process case of tests/test_tracking.py runs on the port
  (``device="cpu"``, the plain kernel versions) and on the reference with
  the same frames, and the port's ``tracker.state_dict()`` equals the
  reference's (every array, dtype included, and the manifest);
- flat ≡ tree ≡ save → load → resume in-process, and the stream half of
  tests/_tracking_script.py's quick sweep (drifting_blobs × {2, 4, 8}
  shards); the dist lanes have no port yet;
- ``BENCH_tracking.json``'s layout rows (3 layouts × {2, 4, 8} shards):
  event counts, ``tracks_total`` and ``id_stability`` equal, and the
  port's state equal to the reference's in each.
"""
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.ddc as J  # noqa: E402
import repro_torch.ddc as T  # noqa: E402
from repro.data import spatial as jsp  # noqa: E402
from repro.serve import tracking as jtrk  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402
from repro_torch.serve import tracking as ttrk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHARD_COUNTS = (2, 4, 8)
EVENT_FIELDS = ("generations", "n_clusters", "tracks_total", "births", "deaths", "merges",
                "splits", "continuations", "id_stability")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def build(mod, layout, k=4, agg=None, **over):
    spec = jsp.TRAJECTORY_LAYOUTS[layout]
    cap = jsp.trajectory_capacity(spec["n_per_step"], spec["window"], k)
    kw = dict(eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
              max_clusters=spec["max_clusters"], max_verts=spec["max_verts"],
              backend="stream", shards=k, capacity=cap, max_batch=min(256, cap),
              agg_degree=agg, track=True)
    kw.update(over)
    cfg = mod.DDCConfig(**kw).validate()
    return mod.DDC(cfg, device="cpu") if mod is T else mod.DDC(cfg)


def frames(layout):
    spec = jsp.TRAJECTORY_LAYOUTS[layout]
    return spec["make"](steps=spec["steps"], n_per_step=spec["n_per_step"])


def play_steps(model, frs, window, start=0):
    """tests/_tracking_script.py's loop: one refresh per frame."""
    k = model.config.shards
    for i, frame in enumerate(frs):
        step = start + i
        for shard, part in enumerate(np.array_split(frame, k)):
            if len(part):
                model.partial_fit(shard, part, t=float(step) * np.ones(len(part)))
        if step + 1 > window:
            model.expire(float(step - window + 1))
        model.service.refresh()


def state(model):
    return model.service.tracker.state_dict()


def assert_states_equal(a, b, what=""):
    (aa, am), (ba, bm) = a, b
    assert am == bm, what
    assert set(aa) == set(ba), what
    for key in sorted(aa):
        x, y = np.asarray(aa[key]), np.asarray(ba[key])
        assert x.dtype == y.dtype, (what, key, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {key}")


def snap_equal(a, b):
    """Two TrackSnapshots (of either package): every field, the track
    views and the events included."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@functools.lru_cache(maxsize=None)
def played(mod_name, layout, k, agg=None):
    """One full play of ``layout`` at ``k`` shards, cached per process:
    (tracker state, final TrackSnapshot)."""
    mod = T if mod_name == "port" else J
    model = build(mod, layout, k, agg=agg)
    trk = ttrk if mod is T else jtrk
    snap = trk.play(model, frames(layout).frames,
                    window=jsp.TRAJECTORY_LAYOUTS[layout]["window"])
    return state(model), snap


# -- trajectory generators ------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(jsp.TRAJECTORY_LAYOUTS))
def test_trajectory_layouts_equal_reference(layout):
    jspec, tspec = jsp.TRAJECTORY_LAYOUTS[layout], tsp.TRAJECTORY_LAYOUTS[layout]
    assert {k: v for k, v in tspec.items() if k != "make"} == \
        {k: v for k, v in jspec.items() if k != "make"}
    assert tspec["make"].__name__ == jspec["make"].__name__
    for kw in (dict(steps=jspec["steps"], n_per_step=jspec["n_per_step"]),
               dict(steps=5, n_per_step=1000, seed=7)):
        a, b = tspec["make"](**kw), jspec["make"](**kw)
        assert isinstance(a, tsp.Trajectory) and len(a.frames) == len(b.frames)
        for fa, fb in zip(a.frames, b.frames):
            assert fa.dtype == fb.dtype == np.float32
            np.testing.assert_array_equal(fa, fb)
        for f in ("centers", "velocities"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_drifting_blobs_options_equal_reference():
    """The chip run's trajectory shape (8 lanes, scaled radius and speed)
    and the one-blob lane."""
    for kw in (dict(steps=6, n_per_step=4096, n_blobs=8, radius=0.02, speed=0.01),
               dict(steps=30, n_per_step=50, n_blobs=1, seed=3)):
        a, b = tsp.make_drifting_blobs(**kw), jsp.make_drifting_blobs(**kw)
        for fa, fb in zip(a.frames, b.frames, strict=True):
            np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(a.centers, b.centers)
        np.testing.assert_array_equal(a.velocities, b.velocities)


@pytest.mark.parametrize("n,window,k", [(96, 4, 2), (96, 4, 8), (32768, 7, 8), (97, 3, 5),
                                        (1, 1, 4)])
def test_trajectory_capacity_equals_reference(n, window, k):
    assert tsp.trajectory_capacity(n, window, k) == jsp.trajectory_capacity(n, window, k)


# -- stable identity + motion analytics -------------------------------------------

def test_drifting_blobs_ids_stable():
    spec = jsp.TRAJECTORY_LAYOUTS["drifting_blobs"]
    (tstate, snap), (jstate, jsnap) = played("port", "drifting_blobs", 4), \
        played("ref", "drifting_blobs", 4)
    assert_states_equal(tstate, jstate)
    assert snap.generation == spec["steps"]
    assert snap.births == 3 and snap.deaths == 0
    assert snap.merges == 0 and snap.splits == 0
    assert snap.continuations == 3 * (spec["steps"] - 1)
    assert sorted(t.track_id for t in snap.alive) == [0, 1, 2]
    assert all(t.born_gen == 1 and t.last_gen == snap.generation for t in snap.alive)
    snap_equal(snap, jsnap)


def test_velocity_and_heading_match_ground_truth():
    traj = frames("drifting_blobs")
    _, snap = played("port", "drifting_blobs", 4)
    floor = 0.25 * jsp.TRAJECTORY_LAYOUTS["drifting_blobs"]["eps"]
    for t in snap.alive:
        b = int(np.argmin(((traj.centers[t.last_gen - 1] - t.centroid) ** 2).sum(1)))
        g1, g0 = t.last_gen, t.last_gen - (t.hits - 1)
        true_v = (traj.centers[g1 - 1, b] - traj.centers[g0 - 1, b]) / (g1 - g0)
        assert abs(t.velocity[0] - true_v[0]) < 5e-3, (t.track_id, true_v)
        assert abs(t.velocity[1] - true_v[1]) < 5e-3
        if t.speed > 2 * floor:
            assert t.motion == ttrk.MOTION_MOVING
            true_heading = np.degrees(np.arctan2(true_v[1], true_v[0]))
            assert abs((t.heading_deg - true_heading + 180) % 360 - 180) < 30.0


def test_merging_crowds_merge_then_split():
    (tstate, snap), (jstate, _) = played("port", "merging_crowds", 4), \
        played("ref", "merging_crowds", 4)
    assert_states_equal(tstate, jstate)
    assert snap.merges >= 1 and snap.splits >= 1
    merge = next(e for e in snap.events if e.kind == "merge")
    split = next(e for e in snap.events if e.kind == "split")
    assert merge.gen < split.gen
    assert merge.partner != merge.track
    assert split.track >= 3
    by = min(snap.alive, key=lambda t: (t.centroid[0] - 0.5) ** 2 + (t.centroid[1] - 0.88) ** 2)
    assert by.born_gen == 1 and by.last_gen == snap.generation
    assert by.motion == ttrk.MOTION_STATIONARY


def test_convoys_common_heading():
    (tstate, snap), (jstate, _) = played("port", "convoys", 4), played("ref", "convoys", 4)
    assert_states_equal(tstate, jstate)
    assert snap.births == 4 and snap.merges == 0 and snap.splits == 0
    east = [t for t in snap.alive if t.centroid[1] < 0.5]
    west = [t for t in snap.alive if t.centroid[1] >= 0.5]
    assert len(east) == 2 and len(west) == 2
    for t in east:
        assert t.motion == ttrk.MOTION_MOVING and abs(t.heading_deg) < 30
    for t in west:
        assert t.motion == ttrk.MOTION_MOVING and abs(abs(t.heading_deg) - 180) < 30


# -- TTL eviction x tracking --------------------------------------------------------

def _two_blob_frame(seed, left=True, right=True, n=64):
    rng = np.random.default_rng(seed)
    parts = []
    if left:
        parts.append(tsp._disc(rng, n, 0.25, 0.5, 0.05))
    if right:
        parts.append(tsp._disc(rng, n, 0.75, 0.5, 0.05))
    return np.clip(np.concatenate(parts), 0, 1).astype(np.float32)


def _ingest(models, frame, t):
    for model in models:
        for shard, part in enumerate(np.array_split(frame, model.config.shards)):
            if len(part):
                model.partial_fit(shard, part, t=float(t) * np.ones(len(part)))


def _small(mod, **over):
    kw = dict(eps=0.02, min_pts=3, grid=48, max_verts=96, max_clusters=8,
              backend="stream", shards=2, capacity=256, max_batch=128, track=True)
    kw.update(over)
    cfg = mod.DDCConfig(**kw).validate()
    return mod.DDC(cfg, device="cpu") if mod is T else mod.DDC(cfg)


def _refresh(models, **kw):
    for m in models:
        m.service.refresh(**kw)
    snaps = [m.tracks() for m in models]
    snap_equal(*snaps)
    assert_states_equal(state(models[0]), state(models[1]))
    return snaps[0]


def test_ttl_eviction_death_and_no_id_reuse():
    models = [_small(T), _small(J)]
    _ingest(models, _two_blob_frame(0), t=0)
    snap = _refresh(models)
    assert snap.births == 2
    right0 = max(snap.alive, key=lambda t: t.centroid[0])
    left0 = min(snap.alive, key=lambda t: t.centroid[0])
    _ingest(models, _two_blob_frame(1, right=False), t=1)
    assert models[0].expire(1.0) == models[1].expire(1.0) > 0
    snap = _refresh(models)
    assert snap.deaths == 1
    death = next(e for e in snap.events if e.kind == "death")
    assert death.track == right0.track_id
    assert not snap.track(right0.track_id).alive and snap.track(left0.track_id).alive
    _ingest(models, _two_blob_frame(2, left=False), t=2)
    snap = _refresh(models)
    reborn = max(snap.alive, key=lambda t: t.centroid[0])
    assert reborn.track_id not in (left0.track_id, right0.track_id)
    assert reborn.track_id == snap.next_track_id - 1
    assert snap.births == 3
    ids = [t.track_id for t in snap.tracks]
    assert ids == sorted(set(ids))


def test_window_age_gauges_equal_reference():
    models = [_small(T, track=False), _small(J, track=False)]

    def gauges():
        got = [(m.stats().gauges.oldest_ts, m.stats().gauges.newest_ts) for m in models]
        assert got[0] == got[1]
        return got[0]

    assert gauges() == (None, None)
    _ingest(models, _two_blob_frame(0), t=5)
    _ingest(models, _two_blob_frame(1), t=7)
    assert gauges() == (5.0, 7.0)
    for m in models:
        m.expire(6.0)
    assert gauges() == (7.0, 7.0)
    for m in models:
        m.expire(100.0)
    assert gauges() == (None, None)


# -- config plumbing / per-call override ---------------------------------------------

@pytest.mark.parametrize("kw", [dict(backend="host", track=True),
                                dict(backend="stream", track=True, track_history=1),
                                dict(backend="stream", match_min_overlap=1.0),
                                dict(backend="stream", match_min_overlap=-0.1)])
def test_tracking_config_validation_equals_reference(kw):
    msgs = []
    for mod in (T, J):
        with pytest.raises(mod.ConfigError) as e:
            mod.DDCConfig(**kw).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("history,overlap", [(1, 0.0), (16, 1.0), (16, -0.1)])
def test_tracker_constructor_errors_equal_reference(history, overlap):
    msgs = []
    for mod, dmod in ((ttrk, T), (jtrk, J)):
        with pytest.raises(ValueError) as e:
            mod.ClusterTracker(dmod.DDCConfig().core(), history=history, min_overlap=overlap)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_tracks_requires_tracking_enabled():
    for mod in (T, J):
        model = build(mod, "drifting_blobs", track=False)
        with pytest.raises(mod.ConfigError, match="tracking is disabled"):
            model.tracks()
        assert model.service.tracker is None and model.service.track_snapshot() is None
    with pytest.raises(T.ConfigError):
        T.DDC(T.DDCConfig(backend="host").validate(), device="cpu").tracks()


def test_per_call_track_override():
    models = [build(T, "drifting_blobs", k=2), build(J, "drifting_blobs", k=2)]
    _ingest(models, _two_blob_frame(0), t=0)
    for m in models:
        m.service.refresh(track=False)
        assert m.service.tracker.generation == 0
        m.service.refresh(force=True, track=True)
        assert m.service.tracker.generation == 1
    _ingest(models, _two_blob_frame(1), t=1)
    _refresh(models)
    assert models[0].service.tracker.generation == 2


def test_track_snapshot_version_matches_labels_snapshot():
    models = [build(T, "drifting_blobs", k=2), build(J, "drifting_blobs", k=2)]
    _ingest(models, _two_blob_frame(0), t=0)
    snap = _refresh(models)
    read = models[0].service.snapshot()
    assert (snap.version, snap.epoch) == (read.version, read.epoch)
    assert models[0].service.track_snapshot() is models[0].tracks()


def test_quarantine_pauses_the_fold():
    """A refresh with a quarantined shard is not folded (post-gate
    generations only), and the fold resumes after recovery — as in the
    reference."""
    models = [build(T, "drifting_blobs", k=2), build(J, "drifting_blobs", k=2)]
    _ingest(models, _two_blob_frame(0), t=0)
    _refresh(models)
    for m in models:
        m.service._quarantine(1, "test fence")
    _ingest(models, _two_blob_frame(1), t=1)
    snap = _refresh(models, force=True)
    assert snap.generation == 1
    for m in models:
        assert m.service.recover(1)
    snap = _refresh(models)
    assert snap.generation == 2


def test_held_tracker_state_survives_later_refreshes():
    """The tracker keeps copies of the generation it last saw, not the
    engine's mirror (written in place by later refreshes): a state taken
    earlier still equals its deep copy after more frames."""
    layout = "merging_crowds"
    spec = jsp.TRAJECTORY_LAYOUTS[layout]
    traj = frames(layout)
    model = build(T, layout, k=2)
    play_steps(model, traj.frames[:6], spec["window"])
    arrays, manifest = state(model)
    prev = dict(model.service.tracker._prev)
    kept = ({k: v.copy() for k, v in arrays.items()},
            {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in prev.items()})
    play_steps(model, traj.frames[6:12], spec["window"], start=6)
    assert_states_equal((arrays, manifest), (kept[0], manifest))
    for k, v in prev.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, kept[1][k], err_msg=k)


# -- exactness: flat vs tree + save/load in-process ---------------------------------

def test_flat_vs_tree_and_save_load_resume(tmp_path):
    layout = "merging_crowds"
    spec = jsp.TRAJECTORY_LAYOUTS[layout]
    traj = frames(layout)
    flat, _ = played("port", layout, 4)
    tree, _ = played("port", layout, 4, 2)
    assert_states_equal(flat, tree, "flat vs tree")
    assert_states_equal(flat, played("ref", layout, 4)[0], "port vs reference")
    half = len(traj.frames) // 2
    part1 = build(T, layout)
    play_steps(part1, traj.frames[:half], spec["window"])
    part1.save(str(tmp_path / "snap"))
    resumed = T.DDC.load(str(tmp_path / "snap"), device="cpu")
    for m in (part1, resumed):
        play_steps(m, traj.frames[half:], spec["window"], start=half)
    assert_states_equal(state(part1), state(resumed), "part1 vs resumed")
    assert_states_equal(flat, state(resumed), "flat vs resumed")


@pytest.mark.parametrize("writer,reader", [(T, J), (J, T)])
def test_tracker_snapshot_crosses_packages(writer, reader, tmp_path):
    """A tracked stream snapshot saved by either package resumes in the
    other to the uninterrupted run's tracker state."""
    layout = "drifting_blobs"
    spec = jsp.TRAJECTORY_LAYOUTS[layout]
    traj = frames(layout)
    half = len(traj.frames) // 2
    model = build(writer, layout, k=2)
    play_steps(model, traj.frames[:half], spec["window"])
    model.save(str(tmp_path / "snap"))
    kw = {"device": "cpu"} if reader is T else {}
    resumed = reader.DDC.load(str(tmp_path / "snap"), **kw)
    play_steps(resumed, traj.frames[half:], spec["window"], start=half)
    assert_states_equal(state(resumed), played("ref", layout, 2)[0])


# -- the stream half of the quick equivalence sweep ----------------------------------

@pytest.mark.parametrize("k", SHARD_COUNTS)
def test_tracking_equivalence_quick(k, tmp_path):
    """drifting_blobs at k shards: stream flat ≡ stream tree ≡
    save → load → resume, bit-identical tracker state."""
    layout = "drifting_blobs"
    spec = jsp.TRAJECTORY_LAYOUTS[layout]
    traj = frames(layout)
    ref, _ = played("port", layout, k)
    assert_states_equal(ref, played("port", layout, k, 2)[0], f"k={k} tree vs flat")
    half = len(traj.frames) // 2
    part1 = build(T, layout, k)
    play_steps(part1, traj.frames[:half], spec["window"])
    part1.save(str(tmp_path / "snap"))
    resumed = T.DDC.load(str(tmp_path / "snap"), device="cpu")
    play_steps(resumed, traj.frames[half:], spec["window"], start=half)
    assert_states_equal(ref, state(resumed), f"k={k} resumed vs flat")


# -- BENCH_tracking.json's layout rows ------------------------------------------------

def stability(snap) -> float:
    """benchmarks/tracking.py's ID-stability rate."""
    late = sum(1 for e in snap.events if e.kind == "birth" and e.gen > 1)
    churn = late + snap.deaths + snap.merges + snap.splits
    denom = snap.continuations + churn
    return 1.0 if denom == 0 else snap.continuations / denom


@pytest.mark.parametrize("k", SHARD_COUNTS)
@pytest.mark.parametrize("layout", sorted(jsp.TRAJECTORY_LAYOUTS))
def test_bench_tracking_layout_rows(layout, k):
    want = next(r for r in json.loads((ROOT / "BENCH_tracking.json").read_text())["rows"]
                if (r["kind"], r["layout"], r["shards"]) == ("layout", layout, k))
    tstate, snap = played("port", layout, k)
    got = {"generations": snap.generation, "n_clusters": len(snap.alive),
           "tracks_total": snap.next_track_id, "births": snap.births, "deaths": snap.deaths,
           "merges": snap.merges, "splits": snap.splits,
           "continuations": snap.continuations, "id_stability": round(stability(snap), 4)}
    assert got == {f: want[f] for f in EVENT_FIELDS}
    assert_states_equal(tstate, played("ref", layout, k)[0], f"{layout} k={k}")
