"""Dry run of the paper's own workload at pod width, on one card: DDC over
256 and 512 lanes under the sync, tree and async phase-2 schedules.

The counterpart of the reference package's ``launch/dryrun_ddc.py``.  The
reference lowers and compiles ``DDC(cfg).backend.make_runner`` on shapes
over 256 and 512 forced host devices and reads FLOPs, bytes and
collective bytes from the compiled HLO (``hlo_cost``, ``roofline``).  The
port has no lowering step, so it **runs** the same runner, with the
reference's ``DDCConfig``, lane counts and schedules, on ``make_d2``
points, every lane on one device.  Per cell it prints the reference's
``cell``, ``points`` and ``wire_budget_bytes``, the ``CommMeter``'s counts
(each must equal its closed form, ``closed_form_meter``), the global
cluster count, the kernel launches (B5's staged compactions apart), peak
device memory and the phase times; then the sync /
async wire-byte ratio at 512 lanes against (K−1)/log2 K.  The
reference's ``hbm_per_device_gb``, ``flops_per_dev``,
``coll_bytes_per_dev``, ``t_compute``, ``t_memory`` and ``t_collective``
come from XLA HLO and TPU roofline constants and have no counterpart
here.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_ddc [--points 65536] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.core import ddc as core_ddc
from repro_torch.data import spatial
from repro_torch.ddc import DDC, DDCConfig
from repro_torch.kernels import contour_dist, ops

LANES = (256, 512)
SCHEDULES = ("sync", "tree", "async")
CONFIG = DDCConfig(eps=0.01, min_pts=4, grid=256, max_clusters=64, max_verts=128,
                   backend="jit")


def wire_budget_bytes(cfg: DDCConfig, n_lanes: int, schedule: str) -> int:
    """The reference's per-lane wire budget: (K − 1) buffers for sync,
    max(log2 K, 1) for the tree and async."""
    return cfg.core().buffer_bytes() * (
        (n_lanes - 1) if schedule == "sync" else max(n_lanes.bit_length() - 1, 1))


def closed_form_meter(schedule: str, k: int, nbytes: int, c: int, degree: int = 2) -> dict:
    """What the meter must count for K = 2^L lanes and a tree of degree 2:
    sync one all-gather (K·(K−1) links) and one K-way merge; async L
    rounds of K links and a pair merge each; the tree L levels of K/2
    member → leader links and a pair merge each, then K − 1 links down."""
    levels = k.bit_length() - 1
    if k != 1 << levels or degree != 2:
        raise ValueError(f"closed forms hold for power-of-two K and degree 2, got {k}, {degree}")
    if schedule == "sync":
        links, collectives, steps, slots = k * (k - 1), 1, 1, k * c
    elif schedule == "async":
        links, collectives, steps, slots = k * levels, levels, levels, 2 * levels * c
    else:
        links, collectives, steps, slots = (levels * k // 2 + k - 1, 2 * levels, levels,
                                            2 * levels * c)
    return {"bytes_total": links * nbytes, "collectives": collectives, "merge_steps": steps,
            "merge_slots": slots}


def run_cell(n_lanes: int, schedule: str, pts: np.ndarray, cfg: DDCConfig = CONFIG,
             device="cuda", trace: dict | None = None) -> dict:
    """One cell: ``DDC(cfg).backend.make_runner`` over ``n_lanes`` lanes,
    run once on ``pts`` on ``device``; raises if the meter differs from
    its closed form.  ``trace`` gets the runner's trace (``make_ddc_fn``'s)."""
    cfg = dataclasses.replace(cfg, schedule=schedule, shards=n_lanes)
    meter = core_ddc.CommMeter()
    model = DDC(cfg, meter=meter, device=device)
    dev = model.device
    run = model.backend.make_runner(len(pts))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    trace = {} if trace is None else trace
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, gcs, _ = run(pts, np.ones(len(pts), bool), trace)
    wall = time.perf_counter() - t0
    launches = {key: v for key, v in ops.launch_counts().items() if v}
    snap = meter.snapshot()
    core = cfg.core()
    want = closed_form_meter(schedule, n_lanes, core.buffer_bytes(), core.max_clusters,
                             core.tree_degree)
    if snap != want:
        raise RuntimeError(f"{schedule} at {n_lanes} lanes: meter {snap}, closed form {want}")
    return {
        "cell": f"ddc_spatial_{n_lanes}lanes_{schedule}",
        "points": len(pts),
        "wire_budget_bytes": wire_budget_bytes(cfg, n_lanes, schedule),
        **snap,
        "merge_calls": trace["merge_calls"],
        "n_clusters": int(gcs.valid.sum()),
        "overflow": bool(gcs.overflow),
        "launches": launches,
        "compact_launches": contour_dist.compact_launches["contour_min_d2"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
        else None,
        "phase1_s": trace["phase1_s"],
        "phase2_s": trace["phase2_s"],
        "wall_s": wall,
    }


def sync_async_ratio(recs: list, n_lanes: int) -> dict:
    """Phase-2 wire bytes of sync over async at ``n_lanes``, beside
    (K−1)/log2 K."""
    by = {r["cell"]: r["bytes_total"] for r in recs}
    s = by[f"ddc_spatial_{n_lanes}lanes_sync"]
    a = by[f"ddc_spatial_{n_lanes}lanes_async"]
    return {"lanes": n_lanes, "sync_async_wire_ratio": s / a,
            "theory": (n_lanes - 1) / (n_lanes.bit_length() - 1)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=65_536)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, nargs="+", default=list(LANES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    pts = spatial.make_d2(args.points)
    recs = []
    for lanes in args.lanes:
        for sched in SCHEDULES:
            rec = run_cell(lanes, sched, pts, device=args.device)
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    ratio = sync_async_ratio(recs, args.lanes[-1])
    print(f"# {ratio['lanes']}-lane phase-2 wire bytes: sync/async = "
          f"{ratio['sync_async_wire_ratio']:.1f}x (theory (K-1)/log2(K) = "
          f"{ratio['theory']:.1f}x)")
    if args.out:
        with open(args.out + ".json", "w") as f:
            json.dump(recs, f, indent=1)
    return recs


if __name__ == "__main__":
    main()
