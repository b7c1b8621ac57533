#!/usr/bin/env python3
"""Drive the PyTorch port's DDC main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels under
``src/repro_torch/kernels/csrc`` are built at first use).  Imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (non-zero exit):

1. The card (``nvidia-smi`` name and power limit) and the kernel build.
2. Full width: ``make_d2`` at 262,144 points in 8 lanes of 32,768 with
   the ``DDCConfig`` defaults (grid 128, 32 clusters, 128 vertices),
   through ``make_ddc_fn`` (sync schedule, dense DBSCAN).  eps starts at
   the 2048-point D2 case's 0.03 scaled to the same expected
   neighbourhood and grows until no cluster budget overflows.  After the
   warm-up, launch counts are zeroed, the path runs once with the kernels
   (every kernel must have launched), then once more with every op on
   its plain PyTorch version on the card; the two runs must agree bit for
   bit.  Each kernel is then held against its plain version on the
   main path's own inputs and timed with CUDA events: one JSON line
   ``{"kernels": [...]}``.  One more main-path run under torch.profiler
   gives the device time by kernel and the device's busy share.
3. Oracle parity: every layout of the reference's phase-2 equivalence
   table at K in {2, 4, 8} lanes, port on the card against the NumPy
   host oracle ``ddc_host(..., contour="grid")``; the clusterings must be
   the same in every cell.
4. The full-width numbers, then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FULL_N = 262_144
LANES = 8
PARITY_SHARDS = (2, 4, 8)
# Published peaks of the H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
NC_OPS_PER_PAIR = 6   # mul, mul, add (dot); add (xx+yy); mul by 2; sub
CMD2_OPS_PER_PAIR = 5  # sub, sub, mul, mul, add


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def median_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _short(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()[:60]


def profile_main_path(torch, run, pts, mask, timed: dict) -> dict:
    """Device time by kernel over one more main-path run under
    torch.profiler, and the device's busy share of the unprofiled run's
    wall time (``timed``).  Kernels run on one stream, so their times do
    not overlap and their sum is the busy time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(pts, mask)
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms, count = rows.get(_short(e.key), (0.0, 0))
        rows[_short(e.key)] = (ms + us / 1e3, count + e.count)
    wall_s = timed["phase1_s"] + timed["phase2_s"]
    if not rows:
        return {"device_ms": "not measured", "wall_s": wall_s}
    device_ms = sum(ms for ms, _ in rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_s": wall_s, "device_ms": device_ms,
            "busy_share": device_ms / 1e3 / wall_s, "device_calls": sum(
                c for _, c in rows.values()),
            "top": [{"name": k, "ms": ms, "calls": c} for k, (ms, c) in top]}


def same(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import dbscan, ddc
    from repro_torch.data import spatial
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. the card and the build ---------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card.splitlines()[0], flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": round(build_s, 3), "built": sorted(built)}), flush=True)

    # -- 2. full width: eps search doubles as the warm-up ----------------
    pts = spatial.make_d2(FULL_N, seed=1)
    mask = np.ones(FULL_N, bool)
    eps = 0.03 * math.sqrt(2048 / FULL_N)
    eps_tried = []
    for _ in range(10):
        cfg = ddc.DDCConfig(eps=eps, min_pts=4, schedule="sync", block_sparse="never")
        run = ddc.make_ddc_fn(cfg, LANES, device=dev)
        _, gcs, _ = run(pts, mask)
        eps_tried.append(eps)
        log(f"eps={eps:.6f} overflow={bool(gcs.overflow)}")
        if not bool(gcs.overflow):
            break
        eps *= 1.25
    else:
        raise RuntimeError(f"cluster budget overflows at every eps tried: {eps_tried}")

    ops.reset_launch_counts()
    tk: dict = {}
    out_k = run(pts, mask, tk)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"kernel run: phase1 {tk['phase1_s']:.4f}s phase2 {tk['phase2_s']:.4f}s "
        f"launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")

    ops.FORCE = "ref"
    try:
        tr: dict = {}
        out_r = run(pts, mask, tr)
        torch.cuda.synchronize()
    finally:
        ops.FORCE = None
    if ops.launch_counts() != launches:
        raise RuntimeError("the plain run launched a kernel")
    mismatches = []
    for name, a, b in [("glabels", out_k[0], out_r[0]), ("my_map", out_k[2], out_r[2])] + [
            (f"gcs.{f}", x, y) for f, x, y in zip(ddc.ClusterSet._fields, out_k[1], out_r[1])] + [
            (f"lane{i}.{f}", x, y)
            for i, (rk, rr) in enumerate(zip(tk["results"], tr["results"]))
            for f, x, y in zip(dbscan.DBSCANResult._fields, rk, rr)]:
        if not same(torch, a, b):
            mismatches.append(name)
    if mismatches:
        raise RuntimeError(f"kernel run differs from the plain run in {mismatches}")
    glabels, gcs, my_map = out_k
    c = cfg.max_clusters
    if glabels.shape != (FULL_N,) or my_map.shape != (LANES * c,) \
            or not bool(torch.isfinite(gcs.contours).all()) \
            or int(glabels.min()) < -1 or int(glabels.max()) >= c:
        raise RuntimeError("full-width output has the wrong shape or range")
    n_global = int(gcs.valid.sum())
    if n_global < 1 or bool(gcs.overflow):
        raise RuntimeError(f"full-width run found {n_global} clusters, overflow "
                           f"{bool(gcs.overflow)}")

    # Each kernel against its plain version on the main path's inputs
    # (lane 0 for phase 1, the stacked batch for phase 2).
    per = FULL_N // LANES
    x0 = torch.as_tensor(pts[:per], device=dev)
    m0 = torch.ones(per, dtype=torch.bool, device=dev)
    xc = dbscan.center_points(x0, m0).contiguous()
    res0 = tk["results"][0]
    lab_in = torch.where(res0.core, res0.labels, dbscan.SENTINEL).to(torch.int32)
    batch = tk["batch"]
    mslots = LANES * c
    v = cfg.max_verts
    conts = batch.contours.reshape(mslots, v, 2).contiguous()
    cnts = batch.counts.reshape(mslots).contiguous()
    valids = batch.valid.reshape(mslots).contiguous()
    n_valid = int(m0.sum())
    p_valid = int(torch.where(valids, cnts.clamp(0, v), 0).sum())
    cases = [
        ("neighbor_count", "pairwise_dist.cu", "src/repro/kernels/pairwise_dist.py:91",
         [per], lambda: ops.neighbor_count(xc, m0, eps),
         lambda: ref.neighbor_count(xc, m0, eps),
         bound(n_valid ** 2 * NC_OPS_PER_PAIR, per * (8 + 1 + 4))),
        ("min_label_sweep", "pairwise_dist.cu", "src/repro/kernels/pairwise_dist.py:147",
         [per], lambda: ops.min_label_sweep(xc, m0, lab_in, res0.core, eps),
         lambda: ref.min_label_sweep(xc, m0, lab_in, res0.core, eps),
         bound(n_valid ** 2 * NC_OPS_PER_PAIR, per * (8 + 1 + 4 + 1 + 4))),
        ("contour_min_d2", "contour_dist.cu", "src/repro/kernels/contour_dist.py:52",
         [mslots, v], lambda: ops.contour_min_d2(conts, cnts, valids),
         lambda: ref.contour_min_d2(conts, cnts, valids),
         bound(p_valid ** 2 * CMD2_OPS_PER_PAIR,
               mslots * v * 8 + mslots * (4 + 1) + mslots * mslots * 4)),
    ]
    kernels = []
    for name, src, replaces, shape, kern, plain, (bound_ms, bound_by) in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        exact = same(torch, got, want)
        err = float((got.double() - want.double()).abs().max())
        if not exact:
            raise RuntimeError(f"{name}: kernel differs from its plain version "
                               f"(max abs err {err})")
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "shape": shape, "launches": launches[name], "exact": exact,
            "max_abs_err": err, "tolerance": 0.0,
            "ms": median_ms(torch, kern, 20), "plain_ms": median_ms(torch, plain, 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }
        log(json.dumps(entry))
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"profile": profile_main_path(torch, run, pts, mask, tk)}), flush=True)

    # -- 3. oracle parity at the tuned 2048-point sizes --------------------
    clusters: dict[str, list[int]] = {}
    for name, (make, p_eps, min_pts, grid, max_verts, max_clusters) in \
            spatial.PARITY_CASES.items():
        lpts = make()
        for k in PARITY_SHARDS:
            pcfg = ddc.DDCConfig(eps=p_eps, min_pts=min_pts, grid=grid,
                                 max_verts=max_verts, max_clusters=max_clusters,
                                 schedule="sync", block_sparse="never")
            gl, pgcs, _ = ddc.make_ddc_fn(pcfg, k, device=dev)(lpts, np.ones(len(lpts), bool))
            host, _, _ = ddc.ddc_host(lpts, k, p_eps, min_pts, contour="grid")
            if bool(pgcs.overflow) or not ddc.same_clustering(gl.cpu().numpy(), host):
                raise RuntimeError(f"parity {name} k={k}: port differs from ddc_host "
                                   f"(overflow {bool(pgcs.overflow)})")
            clusters.setdefault(name, []).append(len(set(host[host >= 0].tolist())))
    print(json.dumps({"parity": {"shards": list(PARITY_SHARDS), "all_same_clustering": True,
                                 "clusters": clusters}}), flush=True)

    # -- 4. the full-width numbers, then the contract line -----------------
    print(json.dumps({"full_width": {
        "n": FULL_N, "lanes": LANES, "eps": eps, "eps_tried": eps_tried,
        "min_pts": cfg.min_pts, "grid": cfg.grid, "max_clusters": c,
        "max_verts": v, "phase1_s": tk["phase1_s"], "phase2_s": tk["phase2_s"],
        "plain_phase1_s": tr["phase1_s"], "plain_phase2_s": tr["phase2_s"],
        "sweeps_per_lane": [int(r.n_sweeps) for r in tk["results"]],
        "lane_clusters": [int(r.n_clusters) for r in tk["results"]],
        "n_clusters": n_global, "launches": launches,
        "bit_identical_to_plain": True}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
