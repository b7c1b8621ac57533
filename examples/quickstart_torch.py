"""Quickstart: the PyTorch port's ``repro_torch.ddc`` estimator API on a
Chameleon-like dataset, on a CUDA card (or the CPU with ``--device cpu``).

The canonical snippet — one config, one facade, either backend:

    from repro_torch.ddc import DDC, DDCConfig

    cfg = DDCConfig(eps=0.022, min_pts=4, backend="jit", shards=8,
                    ...).validate(sample=pts)     # DESIGN §7 sizing probe
    model = DDC(cfg).fit(pts)                     # phase 1 + phase 2
    model.labels_                                 # global cluster ids
    res = model.query(probes)                     # QueryResult (§12):
    res.labels, res.version, res.degraded         #   still duck-types as
    np.asarray(res)                               #   the labels ndarray
    model.query_tier.submit(probes); model.query_tier.drain()
    model.stats()                                 # typed ServiceStats
    model.save(path); DDC.load(path)              # bit-identical resume

``--backend host`` is the paper-faithful NumPy oracle (its read snapshot
and queries on the device), ``jit`` the one-device pipeline on the
port's kernels (sync/async/tree schedules), ``stream`` the online serve
engine (ring-buffer ingest, dirty-shard phase 1, exact delta merge; its
rings on the device), ``dist`` the same engine with each shard's rings
and phase 1 on a lane of its own (a CUDA stream on a card) and measured
exchange bytes.  All four produce the same global clustering.  The
stream and dist runs end with the cluster-tracking demo (``track=True``:
a drifting-blobs trajectory, one tracked refresh per frame).

  PYTHONPATH=src python examples/quickstart_torch.py --backend host
  PYTHONPATH=src python examples/quickstart_torch.py --backend jit --shards 8
  PYTHONPATH=src python examples/quickstart_torch.py --backend stream
  PYTHONPATH=src python examples/quickstart_torch.py --backend dist --shards 8
  PYTHONPATH=src python examples/quickstart_torch.py --backend jit --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import dbscan, partitioner, simulate as sim
from repro_torch.data import spatial
from repro_torch.ddc import DDC, DDCConfig

ap = argparse.ArgumentParser()
ap.add_argument("--backend", choices=("host", "jit", "stream", "dist"),
                default="host")
ap.add_argument("--shards", type=int, default=8)
ap.add_argument("--n", type=int, default=6000)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()


def ascii_plot(pts, labels, width=72, height=24):
    chars = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghij"
    grid = [[" "] * width for _ in range(height)]
    for (x, y), l in zip(pts, labels):
        c = "." if l < 0 else chars[l % len(chars)]
        grid[int((1 - y) * (height - 1))][int(x * (width - 1))] = c
    return "\n".join("".join(row) for row in grid)


def main():
    n, k = args.n, args.shards
    pts = spatial.make_d1(n, seed=0, noise_frac=0.02)

    # One validated config drives every deployment style.  validate()
    # rejects backend/schedule mismatches and (with a sample) configs
    # whose merged contours would overflow the vertex budget (DESIGN §7).
    cfg = DDCConfig(
        eps=0.022, min_pts=4, grid=96, max_clusters=24, max_verts=320,
        backend=args.backend, shards=k,
    ).validate(sample=pts[::2])
    model = DDC(cfg, device=args.device)

    print(f"== DDC on D1-like dataset (n={n}, backend={cfg.backend}, "
          f"{k} shards, device={args.device}) ==")
    # t=0.0 stamps the batch for TTL eviction (stream backend; ignored by
    # the batch backends).
    model.fit(pts, t=0.0)
    glabels = model.labels_
    print(f"global clusters: {model.n_clusters_}   "
          f"noise: {(glabels < 0).sum()}")

    stats = model.comm_stats()
    if cfg.backend == "host":
        # The host oracle ships raw contour vertices: the paper's
        # data-reduction claim, measured directly.
        print(f"phase-2 wire bytes (host): {stats['bytes_total']} vs "
              f"{n * 8} of raw points — only contour representatives "
              f"cross the network")
    else:
        # The pipeline's schedules exchange fixed-size (C, V)-padded
        # ClusterSet buffers, counted exactly by the CommMeter.
        print(f"phase-2 wire bytes ({cfg.backend}): "
              f"{stats['bytes_total']} across {stats['collectives']} "
              f"collectives ({stats['merge_steps']} merge steps) — "
              f"padded ClusterSet buffers, never raw points")

    # Read path: point -> global cluster id (DBSCAN's border rule), from
    # the published snapshot on the device.  query() returns a
    # QueryResult that still duck-types as the labels ndarray.
    probes = np.array([[0.30, 0.65], [0.62, 0.22], [0.02, 0.98]])
    res = model.query(probes)
    print(f"query {probes.tolist()} -> {res.tolist()}   "
          f"(snapshot v{res.version}, degraded={res.degraded})")

    # The high-QPS tier: requests enter a bounded queue and are answered
    # from the last published snapshot in coalesced batched launches.
    tier = model.query_tier
    handles = [tier.submit(probes + 0.01 * i) for i in range(3)]
    tier.drain()
    st = model.stats()                  # the typed ServiceStats contract
    print(f"query tier: {st.counters.queries_served} served in "
          f"{st.counters.query_launches} launches "
          f"({st.counters.coalesced_requests} coalesced), "
          f"p.version={handles[-1].result.version}")

    if cfg.backend in ("stream", "dist"):
        # Streaming extras: timestamped writes and TTL eviction.
        model.partial_fit(0, pts[:64], t=1.0)
        model.expire(t=0.0)              # nothing older than t=0 yet

    # A snapshot of the fitted model restores without a refit.
    with tempfile.TemporaryDirectory() as d:
        model.save(os.path.join(d, "ckpt"))
        restored = DDC.load(os.path.join(d, "ckpt"), device=args.device)
        same = np.array_equal(model.labels_, restored.labels_)
    print(f"snapshot -> restore: labels bit-identical = {same}")

    if cfg.backend in ("stream", "dist"):
        # Cluster tracking (DESIGN §14): with track=True the engine
        # assigns stable track IDs across refreshes and derives motion
        # analytics per track.  Play a drifting-blobs stream — one
        # tracked refresh per frame, sliding-window eviction — and read
        # the TrackSnapshot via model.tracks() (published at the same
        # version as the query tier's Snapshot).
        from repro_torch.serve import tracking
        spec = spatial.TRAJECTORY_LAYOUTS["drifting_blobs"]
        traj = spec["make"](steps=10, n_per_step=spec["n_per_step"])
        tcap = spatial.trajectory_capacity(spec["n_per_step"], spec["window"], k)
        tcfg = DDCConfig(
            eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
            max_clusters=spec["max_clusters"], max_verts=spec["max_verts"],
            backend=cfg.backend, shards=k, capacity=tcap,
            max_batch=min(256, tcap), track=True,
        ).validate()
        snap = tracking.play(DDC(tcfg, device=args.device), traj.frames,
                             window=spec["window"])
        print(f"tracking: {len(snap.alive)} tracks over "
              f"{snap.generation} generations (births={snap.births} "
              f"deaths={snap.deaths} merges={snap.merges} "
              f"splits={snap.splits} "
              f"continuations={snap.continuations})")
        for t in snap.alive:
            print(f"  track {t.track_id}: size={t.size:3d} "
                  f"speed={t.speed:.4f}/gen "
                  f"heading={t.heading_deg:+6.1f}deg  {t.motion}")

    seq = dbscan.dbscan_ref(pts, cfg.eps, cfg.min_pts)
    # Micro-fragments (< 2*min_pts points) can fall below min_pts when a
    # partition boundary splits them — a known DDC property; compare the
    # real clusters.
    big = [c for c in set(seq[seq >= 0])
           if (seq == c).sum() >= 2 * cfg.min_pts]
    print(f"sequential DBSCAN finds {len(big)} clusters (+"
          f"{len(set(seq[seq >= 0])) - len(big)} micro-fragments) -> "
          f"{'MATCH' if len(big) == model.n_clusters_ else 'DIFFER'}")

    sample = np.random.default_rng(0).choice(n, 1200, replace=False)
    print(ascii_plot(pts[sample], glabels[sample]))

    print("\n== sync vs async on the paper's heterogeneous cluster ==")
    for scen in ("I", "IV"):
        sizes = partitioner.scenario_sizes(scen)
        s = sim.simulate(sim.PAPER_MACHINES, sizes, "sync").makespan
        a = sim.simulate(sim.PAPER_MACHINES, sizes, "async").makespan
        print(f"scenario {scen}: sync {s:8.0f} ms | async {a:8.0f} ms "
              f"({'async wins' if a < s else 'sync wins'})")


if __name__ == "__main__":
    main()
