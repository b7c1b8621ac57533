"""The port's serving entry point: the three modes of the reference
package's ``launch/serve.py``, on a CUDA card (``--device cpu`` for the
CPU).

* ``--mode lm`` (default) — the batched LM request loop: ``--requests``
  prompts of ``--prompt-len`` tokens (and an encoder-decoder's frames or a
  VLM's prefix), prefill and ``--gen`` decode steps through
  ``serve/engine.py::greedy_generate``, any ``repro_torch.configs``
  architecture (``--tiny`` for its small configuration).  Parameters,
  prompts, frames and prefix are drawn from one ``torch.Generator`` on the
  device seeded with ``--seed`` (the reference's ``jax.random`` draws
  cannot be reproduced; ``params_from_jax`` carries them across), the
  parameters in float32 as the reference's.  Greedy unless
  ``--temperature`` > 0, which samples with the same generator.
  ``--mesh-devices N`` (N > 1) serves over N rank processes
  (``launch/ranks.py``), the reference's host mesh of N ``data`` lanes
  with the parameters unsharded: every rank draws the same parameters and
  requests, generates for its part of the requests (all of them when
  they do not divide), and the tokens are gathered to rank 0; a sampling
  rank draws for every request and keeps its own rows, so the tokens are
  the one-process run's.  Prints one JSON line with the reference's keys and the device
  (over ranks also their count, the backend and whether collectives
  staged through the host).
* ``--mode ddc`` — the streaming spatial-clustering service: ingest a
  synthetic layout shard by shard with an incremental delta-merge refresh
  after every batch, then serve point -> cluster queries.  Prints one JSON
  line of ingest / query latency, the exchange's comm volume and the
  query-routing and failure counters.
* ``--mode track`` — cluster tracking (DESIGN.md §14): play a seeded
  trajectory stream (``--layout`` from ``TRAJECTORY_LAYOUTS``, default
  ``drifting_blobs``) through a ``track=True`` deployment with
  sliding-window eviction, then print the tracks (ID, velocity, heading,
  motion class) and the lifecycle-event census as one JSON line.

``--backend stream`` (default) is the host-driven engine
(``serve/cluster_service.py``); ``--backend dist`` gives each shard a lane
of its own, a CUDA stream on the card (``serve/dist_service.py``), and
meters the bytes it fetches.  ``--qps-requests N`` appends the pipelined
request loop (DESIGN.md §12): N requests through the bounded
``QueryTier`` queue while the tail of the ingest stream keeps writing and
republishing under them.  ``--fault-seed`` arms a seeded ``FaultPlan``
(the chaos drill, DESIGN.md §11).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --tiny \\
      --requests 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode ddc --layout rings \\
      --shards 8 --queries 512
  PYTHONPATH=src python -m repro_torch.launch.serve --mode ddc --backend dist \\
      --shards 8 --qps-requests 64 --deadline-ms 50
  PYTHONPATH=src python -m repro_torch.launch.serve --mode track \\
      --layout merging_crowds --shards 4 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "ddc", "track"), default="lm")
    # LM mode
    ap.add_argument("--arch")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mesh-devices", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    # DDC streaming mode
    ap.add_argument("--layout", default="rings",
                    help="a data/spatial.py PHASE2_LAYOUTS name (--mode ddc) or "
                         "TRAJECTORY_LAYOUTS name (--mode track, default drifting_blobs)")
    ap.add_argument("--backend", choices=("stream", "dist"), default="stream",
                    help="host-driven or lane-resident serve engine")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="arm a seeded FaultPlan.random against the serve engine "
                         "(chaos drill; DESIGN.md §11)")
    ap.add_argument("--faults", type=int, default=3,
                    help="number of injected fault events (--fault-seed)")
    # DDC high-QPS request loop (DESIGN.md §12)
    ap.add_argument("--qps-requests", type=int, default=0,
                    help="run N requests through the pipelined QueryTier loop, "
                         "interleaved with ingest (0: skip)")
    ap.add_argument("--request-points", type=int, default=32,
                    help="query points per pipelined request")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="bounded request-queue depth (backpressure)")
    ap.add_argument("--max-staleness", default="inf",
                    help="seconds a published snapshot may keep serving ('inf': never "
                         "refresh mid-loop, 'none': fold pending writes before every drain)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline; misses are counted (and still answered) "
                         "(0: no deadline)")
    # DDC tracking mode (DESIGN.md §14)
    ap.add_argument("--steps", type=int, default=0,
                    help="trajectory frames to play (--mode track; 0: the layout's default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (never falls back to the CPU)")
    args = ap.parse_args(argv)
    if args.mode == "ddc":
        return serve_ddc(args)
    if args.mode == "track":
        return serve_track(args)
    if not args.arch:
        ap.error("--arch is required for --mode lm")
    return serve_lm(args)


def serve_lm(args, *, cfg=None, model=None, prompts=None, frames=None, prefix=None):
    """The LM request loop (the reference's ``serve_lm``): one greedy
    generation of ``args.gen`` tokens for ``args.requests`` prompts, timed,
    printed as one JSON line; returns the tokens (requests, gen).  A
    caller may hand over the configuration (in place of ``args.arch``'s,
    e.g. one cut in depth), the model, prompts, frames or prefix (a parity
    check with the reference's draws); what it leaves out is drawn from
    the seeded generator, in the reference's order."""
    import torch

    from repro_torch.launch import ranks
    from repro_torch.models import transformer as T

    n = args.mesh_devices or 1
    if n <= 1:
        out, line = _serve_lm(args, None, cfg, model, prompts, frames, prefix)
    else:
        T._device(args.device)
        host = {k: v if v is None or not isinstance(v, torch.Tensor) else v.cpu()
                for k, v in dict(model=model, prompts=prompts, frames=frames,
                                 prefix=prefix).items()}
        timing: dict = {}
        res = ranks.run_cases([ranks.Case(serve_rank, n, (args, cfg, host))], n,
                              device=args.device, timing=timing)[0][0]
        out, line = torch.as_tensor(res[0]), res[1]
    print(json.dumps(line))
    return out


def serve_rank(rank, group, dev, args, cfg, given):
    """One rank of ``--mesh-devices N``: (the gathered tokens as an array,
    the JSON line's fields)."""
    from repro_torch.launch import mesh as mesh_mod

    args = argparse.Namespace(**{**vars(args), "device": str(dev)})
    given = {k: None if v is None else v.to(dev) for k, v in given.items()}
    out, line = _serve_lm(args, mesh_mod.make_host_mesh(group=group, device=dev), cfg,
                          **given)
    return out.cpu().numpy(), line


def _serve_lm(args, mesh, cfg=None, model=None, prompts=None, frames=None, prefix=None):
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par
    from repro_torch.parallel import collectives as coll
    from repro_torch.serve import engine

    if cfg is None:
        cfg = configs.get_config(args.arch)
        if args.tiny:
            cfg = cfg.tiny()
    dev = T._device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if model is None:
        model = T.init_params(cfg, gen, device=dev)
    scfg = engine.ServeConfig(max_len=args.prompt_len + args.gen + cfg.prefix_len)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len), generator=gen,
                                device=dev)
    kw = {}
    if cfg.frontend == "audio_stub":
        kw["frames"] = frames if frames is not None else torch.randn(
            (args.requests, cfg.frontend_seq, cfg.d_model), generator=gen, device=dev) * 0.1
    if cfg.prefix_len:
        kw["prefix"] = prefix if prefix is not None else torch.randn(
            (args.requests, cfg.prefix_len, cfg.d_model), generator=gen, device=dev) * 0.1

    pctx = par.ParallelCtx(mesh=mesh)
    split = False
    if mesh is not None:
        local, split = pctx.shard_batch({"prompts": prompts, **kw})
        prompts = local.pop("prompts")
        kw = local
        pctx = dataclasses.replace(pctx, batch_sharded=split)
    t0 = time.time()
    with par.use(pctx):
        out = engine.greedy_generate(
            cfg, model, prompts, args.gen, scfg, temperature=args.temperature,
            generator=gen if args.temperature > 0 else None, **kw)
        if split:
            out = coll.gather_raw(out, mesh, pctx.dp_axes, 0)
    dt = time.time() - t0
    toks = args.requests * args.gen
    line = {
        "requests": args.requests,
        "generated_tokens": toks,
        "wall_s": round(dt, 3),
        "tok_per_s": round(toks / dt, 2),
        "sample_output": out[0][:8].tolist(),
        "device": str(dev),
    }
    if mesh is not None:
        line.update(ranks=mesh.size, backend=mesh.backend, staged=mesh.staged)
    return out, line


def serve_ddc(args):
    from repro_torch.data import spatial
    from repro_torch.ddc import DDC, CommMeter, DDCConfig
    from repro_torch.serve import faults as faults_mod

    spec = spatial.PHASE2_LAYOUTS[args.layout]
    pts = spec["make"](args.n)
    cap = spatial.shard_capacity(args.n, args.shards)
    staleness = None if str(args.max_staleness).lower() == "none" \
        else float(args.max_staleness)
    cfg = DDCConfig(
        eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
        max_clusters=spec["max_clusters"], max_verts=spec["max_verts"],
        backend=args.backend, shards=args.shards, capacity=cap,
        max_batch=min(args.batch, cap), max_queries=args.queries,
        queue_depth=args.queue_depth, max_staleness=staleness,
    ).validate()
    meter = CommMeter()
    plan = None
    if args.fault_seed is not None:
        plan = faults_mod.FaultPlan.random(
            seed=args.fault_seed, shards=args.shards, n_faults=args.faults)
    model = DDC(cfg, meter=meter, faults=plan, device=args.device)

    # With a request loop armed, hold back the stream's tail so writes
    # keep landing (and republishing snapshots) under the readers.
    batches = list(spatial.stream_batches(pts, args.shards, cfg.max_batch))
    n_held = 0
    if args.qps_requests > 0:
        n_held = min(len(batches) - 1, max(args.shards, 2))
    head, held = batches[:len(batches) - n_held], batches[len(batches) - n_held:]

    t0 = time.time()
    n_batches = 0
    for shard, chunk in head:
        model.partial_fit(shard, chunk)
        model.service.refresh()
        n_batches += 1
    ingest_s = time.time() - t0

    recovered = []
    if plan is not None:
        # Chaos drill epilogue: rejoin every quarantined shard and fold the
        # replayed state back in before measuring queries.
        recovered = model.service.recover_all()
        model.service.refresh()

    rng = np.random.default_rng(args.seed)
    q = rng.uniform(0, 1, (args.queries, 2)).astype(np.float32)
    model.query(q[:1])         # warm-up, as the reference's compile call
    t0 = time.time()
    labels = model.query(q)
    query_s = time.time() - t0

    qps_out = {}
    if args.qps_requests > 0:
        qps_out = _request_loop(model, held, args, rng)

    stats = model.service.stats()
    out = model.comm_stats() | {
        "mode": "ddc",
        "layout": args.layout,
        "ingest_batches": n_batches,
        "ingest_ms_per_batch": round(ingest_s / max(n_batches, 1) * 1e3, 2),
        "query_ms": round(query_s * 1e3, 2),
        "query_clustered_frac": round(float(np.mean(labels >= 0)), 3),
        "query_version": labels.version,
        "refreshes": stats["refreshes"],
        "retries": stats["retries"],
        "quarantined_shards": stats["quarantined_shards"],
        "quarantined_now": stats["quarantined_now"],
        "fenced_deltas": stats["fenced_deltas"],
        "degraded_queries": stats["degraded_queries"],
        "journal_entries": stats["journal_entries"],
        "device": str(model.device),
    } | qps_out
    if args.fault_seed is not None:
        out["fault_seed"] = args.fault_seed
        out["recovered_shards"] = recovered
    print(json.dumps(out))
    return out


def serve_track(args):
    """The cluster-tracking mode (DESIGN.md §14): play a seeded
    trajectory stream through a ``track=True`` deployment — one tracked
    refresh per frame, sliding-window eviction — then print the live
    tracks and the lifecycle-event census as one JSON line."""
    from repro_torch.data import spatial
    from repro_torch.ddc import DDC, DDCConfig
    from repro_torch.serve import tracking

    layout = args.layout
    if layout not in spatial.TRAJECTORY_LAYOUTS:
        if layout != "rings":      # the --mode ddc default, not a choice
            raise SystemExit(
                f"--mode track needs a TRAJECTORY_LAYOUTS name "
                f"{sorted(spatial.TRAJECTORY_LAYOUTS)}, got {layout!r}")
        layout = "drifting_blobs"
    spec = spatial.TRAJECTORY_LAYOUTS[layout]
    steps = args.steps or spec["steps"]
    traj = spec["make"](steps=steps, n_per_step=spec["n_per_step"])
    cap = spatial.trajectory_capacity(spec["n_per_step"], spec["window"], args.shards)
    cfg = DDCConfig(
        eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
        max_clusters=spec["max_clusters"], max_verts=spec["max_verts"],
        backend=args.backend, shards=args.shards, capacity=cap,
        max_batch=min(256, cap), track=True,
    ).validate()
    model = DDC(cfg, device=args.device)

    t0 = time.time()
    snap = tracking.play(model, traj.frames, window=spec["window"])
    wall_s = time.time() - t0

    tracker = model.service.tracker
    out = {
        "mode": "track",
        "layout": layout,
        "backend": args.backend,
        "shards": args.shards,
        "generations": snap.generation,
        "snapshot_version": snap.version,
        "births": snap.births,
        "deaths": snap.deaths,
        "merges": snap.merges,
        "splits": snap.splits,
        "continuations": snap.continuations,
        "match_ms_per_refresh": round(tracker.update_ms_total / max(snap.generation, 1), 3),
        "wall_ms_per_frame": round(wall_s / steps * 1e3, 2),
        "tracks": [{
            "id": t.track_id,
            "size": t.size,
            "centroid": [round(c, 4) for c in t.centroid],
            "speed": round(t.speed, 5),
            "heading_deg": round(t.heading_deg, 1),
            "motion": t.motion,
        } for t in snap.alive],
        "device": str(model.device),
    }
    print(json.dumps(out))
    return out


def _request_loop(model, writes, args, rng):
    """The pipelined high-QPS loop (DESIGN.md §12): requests enter the
    bounded ``QueryTier`` queue with per-request deadlines and are
    answered in coalesced batched launches from the last published
    snapshot, while held-back ingest batches keep writing (and
    republishing new versions) underneath."""
    from repro_torch.serve.query_tier import QueueFull

    tier = model.query_tier
    writes = list(writes)
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None

    def one_request():
        return rng.uniform(0, 1, (args.request_points, 2)).astype(np.float32)

    tier.query(one_request())   # warm-up, as the reference's compile call
    pending = []
    t0 = time.time()
    for r in range(args.qps_requests):
        cutoff = (time.monotonic() + deadline_s) if deadline_s else None
        try:
            pending.append(tier.submit(one_request(), deadline=cutoff))
        except QueueFull:
            tier.drain()
            pending.append(tier.submit(one_request(), deadline=cutoff))
        if writes and r % 4 == 1:
            # A write + republish lands under the readers: the next drain
            # serves the new version, never a torn intermediate.
            shard, chunk = writes.pop(0)
            model.partial_fit(shard, chunk)
            model.service.refresh()
        if r % 8 == 7:
            tier.drain()
    for shard, chunk in writes:   # drain any leftover held-back ingest
        model.partial_fit(shard, chunk)
        model.service.refresh()
    tier.drain()
    wall = time.time() - t0

    lat = np.array([p.result.latency_ms for p in pending])
    c = tier.counters()
    return {
        "qps_requests": len(pending),
        "qps": round(len(pending) / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)), 3),
        "p99_ms": round(float(np.percentile(lat, 99)), 3),
        "versions_served": len({p.result.version for p in pending}),
        "query_launches": c["query_launches"],
        "coalesced_requests": c["coalesced_requests"],
        "deadline_misses": c["deadline_misses"],
        "queue_depth": tier.queue_depth,
    }


if __name__ == "__main__":
    main()
