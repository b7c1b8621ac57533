#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them:
DDC's pipeline and the LM stack's serving path.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels under
``src/repro_torch/kernels/csrc`` are built at first use).  Imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (non-zero exit):

1. The card (``nvidia-smi`` name and power limit) and the kernel build.
LM. The serving path at full width: qwen3-8b (36 layers, d_model 4096,
   GQA 32/8, the flash_attention kernel) and mamba2-1.3b (48 layers,
   d_model 2048, the ssd_scan kernel) at full depth, and llama4-scout
   (d_model 5120, GQA 40/8, 16 experts of 8,192 top-1 plus a shared
   expert, vocab 202,048: flash_attention and the MoE dispatch_gather)
   cut to 4 of its 48 layers (``LM_LAYERS``), bf16 weights drawn from a
   seeded ``torch.Generator`` with the reference's scales, 4 requests of
   2,048 prompt tokens each (seeded), ``greedy_generate`` for 16 tokens
   (max_len 2,064).  Per model: attention and SSD launch once per layer in
   prefill and nowhere else, the MoE gather once per MoE layer in prefill
   and in each decode step (launch counts zeroed just before the run and
   read just after), and in bf16 every attention launch takes the
   tensor-core route (``flash_attention_tc.cu``: 36 for qwen3-8b, 4 for
   llama4-scout) and every SSD launch too (``ssd_scan_tc.cu``: 48 for
   mamba2-1.3b) while the float32 run below takes the CUDA-core ones
   (``flash_attention.cu``, ``ssd_scan.cu``), by the route counts; a
   second kernel run gives bit-identical tokens and logits; the same path under ``ops.FORCE = "ref"`` (the plain versions,
   routed as the reference routes off the TPU), teacher-forced on the
   kernel run's tokens, is held to the kernel run on the prefill's
   last-token logits and on every decode step's logits, in bf16 and with
   the weights cast to float32 (tolerances at ``LM_F32_TOL`` and
   ``LM_BF16_NOISE``); in bf16 the plain run routes every MoE token by
   the kernel run's decisions (replayed from its route log, the gates
   from its own probabilities), so that a routing flip between two bf16
   runs is not what the gate measures; how many greedy tokens the plain
   run would pick alike is reported, not gated.  For llama4-scout the
   token-copies dropped at capacity are printed per layer, and the
   routing decisions that differ between the kernel and plain runs in
   float32, where there must be none, and in bf16 without the replay
   (reported; with it they are 0 by construction, and checked).  Prefill time, decode time per token,
   tokens/s and peak memory are printed beside the card.  Each LM kernel
   is held against its plain version on the inputs the main path gave its
   first layer, in bf16 and cast up to float32, and on ``FLASH_SWEEP`` and
   ``SSD_SWEEP`` (tests/test_kernels.py's shapes, ragged lengths, windows,
   bf16, each case on the route its dtype and shape pick), at
   ``LM_KERNEL_F32_TOL`` and ``bf16_tol``, the CUDA-core kernels also timed
   and held on the bf16 first-layer inputs; the MoE gather bit for bit in
   both modes, there and on ``MOE_GATHER_SWEEP``; flash_attention is also
   timed at prefill_32k's length (one sequence, one layer's q/k/v) beside
   the CUDA-core kernel and ``scaled_dot_product_attention``, not gated.
2. Full width: ``make_d2`` at 262,144 points in 8 lanes of 32,768 with
   the ``DDCConfig`` defaults (grid 128, 32 clusters, 128 vertices,
   ``block_sparse="auto"``, tile 512), through ``make_ddc_fn``.  eps
   starts at the 2048-point D2 case's 0.03 scaled to the same expected
   neighbourhood and grows until no cluster budget overflows (sync
   schedule).  Each path below is driven with the launch counts zeroed
   just before it and read just after; each of its kernels must have
   launched, two kernel runs must be identical, and the kernel run must
   equal the same path on the plain PyTorch versions on the card bit for
   bit:
   - the default configuration (sync), which takes the block-sparse
     DBSCAN path (Morton sort, tile-pair pruning, the two sparse kernels)
     in every lane — it fails otherwise;
   - ``block_sparse="never"``, the dense path, which must agree with the
     sparse one in global labels, maps, the merged ClusterSet and every
     lane's labels, core masks and cluster counts;
   - the default path under the ``async`` and ``tree`` schedules
     (phase-2 times and the ``CommMeter``'s counts printed).  Their
     clustering equals sync's only under the reference's vertex-budget
     rule (DESIGN.md §7), which the full-width lanes break at grid 128
     (their outlines fill any budget up to 4,096 vertices), so agreement
     with sync is reported there; it is held through the facade
     (``DDC(DDCConfig(backend="jit", ...))``) at full width on ``UNCUT``
     (make_d2, eps 0.01, min_pts 24, grid 128, max_verts 2,048), where the
     noise stays noise, no local or merged contour fills max_verts and
     the data holds at least 3 global clusters: the three schedules must
     give the same clustering and equal cluster counts;
   - K-Means (``local_algo="kmeans"``, k 8, 25 Lloyd steps, async merge):
     208 ``pairwise_dist_sq`` launches, and every lane's labels, centroids
     and inertia equal to the plain run's, both seeded alike;
   - the delta merge (``merge_delta``, the stream engine's phase 2): the
     default path's batch with lanes ``DELTA_DIRTY`` replaced by a second
     full-width local phase's (``make_d2`` at ``DELTA_SEED``) and folded
     into the old batch's cached matrix by one rectangular
     ``cross_min_d2``; it, one dirty lane and an exclude case must equal
     the rebuild (matrix bit for bit, maps, merged set) and the plain run,
     the square and rectangular rebuilds bit-identical; device times of the
     patches and the rebuilds (``delta_full_width`` line).
   Each kernel is then held against its plain version on the main paths'
   own inputs and timed with CUDA events (``pairwise_dist_sq`` also
   beside ``torch.cdist``; the two counts and the two sweeps, which test
   each unordered pair once (``csrc/pair_sweep.cu``), with their work
   items; ``contour_min_d2`` with its work items (each unordered pair of
   distinct valid slots once) and ``cross_min_d2`` on the delta merge's 96 dirty
   rows; each of these with two launches bit-identical), beside the launch
   floor (an empty kernel timed the same way, ``launch_floor`` line, each
   entry's ``floor_ms``): one JSON line ``{"kernels": [...]}`` that also
   lists the LM phase's three kernels.  One more
   default-path run, one more dense run and one more K-Means run under
   torch.profiler give the device time by kernel and the device's busy
   share (``profile``, ``profile_dense``, ``profile_kmeans``); the default
   and dense profiles must show the count and sweep kernels of their
   path.  Then the facade at full width (``facade_full_width`` line, the
   card beside every number): ``DDC(DDCConfig(eps, min_pts=4,
   backend="jit", shards=8, schedule=s)).fit`` on the same set for sync
   and async, whose ``labels_`` must equal those paths' global labels bit
   for bit, with B3, B4 and B5 launched inside the fit; its query tier on
   8,192 probes (``FACADE_PROBES``: fitted points, points within ±eps of
   them, points outside the bounds), once through ``query`` and once as
   32 requests through ``submit`` / ``drain`` (coalesced), whose labels
   must equal the same snapshot's query on the CPU bit for bit (probes
   per second, ms and peak memory of a launch); save and ``DDC.load`` on
   the card (labels, answers and gauges unchanged, no refit, the
   snapshot's bytes); the host backend on the card beside the jit backend
   at the 2,048-point ``PHASE2_LAYOUTS``, k in {2, 4, 8} (the same
   clustering; the host backend cannot run at full width: ``dbscan_ref``
   builds an n × n float64 matrix); ``validate(sample=...)`` on 4,096
   points of the set, timed, its verdict printed; the fit's wall time
   beside the path's phase times, and the device's busy share over one
   fit and one drain.
3. ``BENCH_phase1.json``'s 9 scenarios on the card: the active tile-pair
   counts must equal the committed ones, and at 4,096 and 16,384 points
   block-sparse DBSCAN (its sparse kernels forced on) must equal dense
   DBSCAN in labels and core masks, with the committed cluster counts.
4. Oracle parity: every layout of the reference's phase-2 equivalence
   table at K in {2, 4, 8} lanes, under sync with ``block_sparse``
   "never" and "auto", and under async and tree with "never", port on the
   card against the NumPy host oracle ``ddc_host(..., contour="grid")``;
   the clusterings must be the same in all 108 runs (81 layout × K ×
   schedule cells).
5. ``BENCH_phase2.json``'s 60 rows (4 layouts × 3 schedules × K in {2,
   …, 32}) on the card: the ``CommMeter``'s merge steps, merge slots,
   bytes and collectives, the global cluster count and the match with
   ``ddc_host`` must equal the committed values.
6. The full-width numbers, then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FULL_N = 262_144
LANES = 8
PARITY_SHARDS = (2, 4, 8)
# The schedule-equivalence check: make_d2 at full width with an eps and
# min_pts at which the 4 % uniform noise stays noise (at the searched eps
# its points are core and join every shape into one cluster), on a raster
# and budget no local or merged contour fills (DESIGN.md §7).
UNCUT = dict(eps=0.01, min_pts=24, grid=128, max_verts=2048)
UNCUT_MIN_CLUSTERS = 3
# The facade at full width: query probes (fitted points, points jittered
# within ±eps of fitted points, points outside the bounds), the requests
# the tier's drain coalesces, and the host backend's cells.
FACADE_PROBES = (4096, 3072, 1024)
FACADE_REQUESTS = 32
FACADE_SAMPLE = 4096
FACADE_HOST_N = 2048
# (schedule, block_sparse) of the parity runs: sync on both phase-1 paths,
# then the two other schedules.
PARITY_RUNS = (("sync", "never"), ("sync", "auto"), ("async", "never"), ("tree", "never"))
# Published peaks of the H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
NC_OPS_PER_PAIR = 6   # mul, mul, add (dot); add (xx+yy); mul by 2; sub
CMD2_OPS_PER_PAIR = 5  # sub, sub, mul, fma (two)
PD_OPS_PER_PAIR = 6    # as NC_OPS_PER_PAIR; the clip at 0 is a select
BENCH_SWEEP_NS = (4096, 16384)  # BENCH_phase1.json rows with cluster counts
# The delta merge at full width: the default path's batch with these lanes
# replaced by a second local phase's (make_d2 at DELTA_SEED), and the lane
# its exclude case quarantines.
DELTA_DIRTY = (1, 3, 6)
DELTA_ONE = 3
DELTA_EXCLUDE = 5
DELTA_SEED = 2
SPIN_CYCLES = 20_000_000  # ≈ 11 ms at 1.75 GHz: longer than the host takes to enqueue
# The LM phase: three full-width models, each with the LM kernel whose
# first-layer inputs its run captures for the per-kernel check.
LM_ARCHS = {"qwen3-8b": "flash_attention", "mamba2-1.3b": "ssd_scan",
            "llama4-scout-17b-a16e": "dispatch_gather"}
# Depth cut by one card's 80 GB: llama4-scout's 48 layers are 2.202 B
# parameters each (216 GB in bf16); 4 layers and the embedding and head are
# 21.8 GB, beside which the float32 anchor copy (43.5 GB) still fits.
LM_LAYERS = {"llama4-scout-17b-a16e": 4}
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 2048, 16
LONG_PREFILL = 32_768  # prefill_32k's sequence length
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
# The kernel run against the plain run of the same path, per step's logits
# (prefill's last token, then each decode step teacher-forced on the kernel
# run's tokens):
# - in float32 (the same weights cast up): |kernel − plain| <= atol +
#   rtol·|plain| with (rtol, atol) = LM_F32_TOL, tests/test_models.py's
#   whole-model 5e-4;
# - in bf16, as served: the two sum in another order, so single bf16
#   roundings differ and grow through the layers.  The RMS of kernel −
#   plain must stay within LM_BF16_NOISE times the RMS of the plain bf16
#   run's own distance from the plain float32 run: the kernel may differ
#   from the plain version by no more than bf16 arithmetic differs from
#   float32 on the same path.
LM_F32_TOL = (5e-4, 5e-4)
LM_BF16_NOISE = 2.0
# Each LM kernel against its plain version on the same inputs.  Both
# compute in float32 and round once to the output's dtype, so:
# - in float32 they differ only by the order of their sums:
#   tests/test_kernels.py's (rtol, atol), LM_KERNEL_F32_TOL;
# - in bf16 a correct kernel differs by at most one bf16 unit in the last
#   place (<= 2^-7 of the value: 8 significant bits), where the two float32
#   results fall on either side of a rounding edge, plus float32 noise near
#   zero: rtol LM_KERNEL_BF16_RTOL and an atol of LM_KERNEL_BF16_ATOL_FRAC
#   times the largest |plain| output.
LM_KERNEL_F32_TOL = {"flash_attention": (3e-4, 3e-4), "ssd_scan": (5e-4, 5e-4)}
LM_KERNEL_BF16_RTOL = 2.0 ** -7
LM_KERNEL_BF16_ATOL_FRAC = 2.0 ** -12
# tests/test_kernels.py's TestFlashAttention and TestSSDScan shapes, then
# ragged lengths, decode (sq = 1), the head-dim buckets' edges and the
# models' own heads in bf16; then the tensor-core route (bf16 at d 64 and
# 128) on GQA, MQA, non-causal, windowed, ragged (sq and skv not multiples
# of its 128-row tiles), sq < 64, a decode query against a cache, and the
# (b, s, h, d) views that layers.gqa_qkv hands over ("bshd").  Each case held
# as the LM kernels are above, and on the route flash_attention.route picks.
FLASH_SWEEP = [
    # b, h, hkv, sq, skv, d, causal, window, bf16, layout
    (1, 4, 4, 128, 128, 32, True, None, False, "bhsd"),     # MHA square
    (2, 8, 2, 128, 256, 64, True, None, False, "bhsd"),     # GQA, decode-style kv > q
    (1, 4, 1, 256, 256, 32, True, None, False, "bhsd"),     # MQA
    (2, 2, 2, 64, 64, 128, True, None, False, "bhsd"),      # large head dim
    (1, 2, 2, 128, 128, 32, False, None, False, "bhsd"),    # non-causal
    (1, 2, 2, 192, 192, 32, True, 32, False, "bhsd"),       # windowed
    (1, 2, 2, 192, 192, 32, True, 100, False, "bhsd"),
    (1, 2, 2, 128, 128, 32, True, None, True, "bhsd"),      # bf16 (CUDA cores)
    (1, 4, 2, 100, 173, 64, True, None, False, "bhsd"),     # ragged sq and skv
    (1, 4, 2, 100, 173, 64, True, 50, True, "bhsd"),        # ragged, windowed, bf16
    (2, 4, 4, 1, 77, 128, True, None, False, "bhsd"),       # one decode query
    (1, 3, 1, 45, 45, 80, False, 7, False, "bhsd"),         # d between buckets
    (1, 3, 1, 45, 45, 80, False, 7, True, "bhsd"),          # bf16 off the tensor cores
    (1, 2, 2, 33, 70, 16, True, None, False, "bhsd"),       # smallest bucket
    (1, 2, 1, 65, 65, 256, True, None, False, "bhsd"),      # largest bucket
    (1, 32, 8, 300, 300, 128, True, None, True, "bhsd"),    # qwen3-8b heads
    (2, 8, 2, 128, 256, 128, True, None, True, "bhsd"),     # tensor cores: GQA
    (1, 4, 1, 256, 256, 64, True, None, True, "bhsd"),      # MQA
    (1, 2, 2, 128, 128, 128, False, None, True, "bhsd"),    # non-causal
    (1, 2, 2, 192, 192, 64, True, 32, True, "bhsd"),        # windowed
    (1, 2, 2, 300, 300, 128, True, 100, True, "bhsd"),      # window across tiles
    (1, 4, 2, 100, 173, 128, True, None, True, "bhsd"),     # ragged sq and skv
    (1, 4, 2, 200, 333, 64, False, None, True, "bhsd"),     # ragged, non-causal
    (1, 4, 4, 33, 70, 128, True, None, True, "bhsd"),       # sq < 64
    (2, 8, 2, 1, 300, 128, True, None, True, "bhsd"),       # one query against a cache
    (1, 4, 4, 1, 77, 64, True, None, True, "bhsd"),
    (2, 32, 8, 200, 200, 128, True, None, True, "bshd"),    # gqa_qkv's strided views
    (1, 4, 2, 150, 150, 64, True, 64, True, "bshd"),
]
# tests/test_kernels.py's TestSSDScan shapes, ragged lengths, ds 256 and bf16
# on the CUDA cores; then the tensor-core route (bf16 at dh 64, ds 128) on a
# ragged l, l < 64, l = 1, one whole chunk, b > 1, and the Mamba layer's
# views ("mamba": x a slice of the conv output, c broadcast over the heads
# with stride 0).  Each case on the route ssd_scan.route picks.
SSD_SWEEP = [
    # b, l, h, dh, ds, bf16, layout
    (1, 64, 2, 16, 8, False, "dense"),
    (2, 128, 3, 16, 8, False, "dense"),
    (1, 256, 1, 32, 16, False, "dense"),
    (2, 96, 4, 8, 4, False, "dense"),
    (2, 100, 3, 16, 8, False, "dense"),             # test_chunked_ref's ragged l
    (2, 100, 3, 16, 8, True, "dense"),              # bf16 (CUDA cores)
    (1, 1, 2, 16, 8, False, "dense"),
    (1, 333, 4, 64, 128, False, "dense"),           # mamba2-1.3b's head, ragged
    (2, 70, 3, 40, 256, False, "dense"),
    (2, 70, 3, 64, 256, True, "dense"),             # bf16 off the tensor cores
    (1, 300, 4, 64, 128, True, "dense"),            # tensor cores: ragged l
    (1, 50, 2, 64, 128, True, "dense"),             # l < 64
    (1, 1, 2, 64, 128, True, "dense"),              # l = 1
    (1, 64, 2, 64, 128, True, "dense"),             # one whole chunk
    (3, 200, 3, 64, 128, True, "dense"),            # b > 1
    (2, 130, 4, 64, 128, True, "mamba"),            # the layer's strided views
    (1, 1000, 2, 64, 128, True, "mamba"),
]
# The MoE dispatch gather (a copy, or one IEEE division and rounding per
# element) against its plain version bit for bit, in both modes:
# tests/test_moe_gather.py's shapes and int8 dtypes, every slot empty, ids
# >= t (empty slots, as on the CPU), rows that are not 16-byte multiples, a
# row-strided x, and llama4-scout's decode shape.
MOE_GATHER_SWEEP = [
    # t, d, s, dtype, layout
    (64, 16, 256, "float32", "rows"),
    (128, 32, 128, "float32", "rows"),
    (32, 8, 512, "float32", "rows"),
    (64, 16, 128, "bfloat16", "rows"),
    (8, 4, 32, "float32", "empty"),
    (50, 13, 77, "bfloat16", "beyond"),             # ids >= t: empty slots too
    (50, 13, 77, "float32", "rows"),
    (50, 13, 77, "bfloat16", "rows"),
    (40, 24, 60, "bfloat16", "strided"),
    (40, 24, 60, "float32", "strided"),
    (4, 5120, 16, "bfloat16", "rows"),
]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def bound(ops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """The least time (ms) the card could take: operations over ``peak``
    (the rate for the inputs' type) or bytes over the memory rate,
    whichever is longer."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def median_ms(torch, fn, reps: int, per: int = 1) -> float:
    """Device time of one call of ``fn``, by CUDA events: the median over
    ``reps`` batches of ``per`` calls, each batch enqueued behind a spin
    kernel so that the calls run back to back at the device's pace, not
    the host's launch rate (a call that syncs with the host still waits
    for it, and is timed with that wait)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def _short(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()[:60]


def same(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def differences(torch, ddc, dbscan, out_a, out_b, trace_a, trace_b, fields) -> list[str]:
    """Names of the outputs that differ between two full-width runs: global
    labels, map, every ClusterSet field, and the listed DBSCANResult
    fields of every lane."""
    pairs = [("glabels", out_a[0], out_b[0]), ("my_map", out_a[2], out_b[2])]
    pairs += [(f"gcs.{f}", x, y) for f, x, y in zip(ddc.ClusterSet._fields, out_a[1], out_b[1])]
    pairs += [(f"lane{i}.{f}", getattr(ra, f), getattr(rb, f))
              for i, (ra, rb) in enumerate(zip(trace_a["results"], trace_b["results"]))
              for f in fields]
    return [name for name, a, b in pairs if not same(torch, a, b)]


def full_width_path(torch, ddc, dbscan, ops, cfg, plain_cfg, pts, mask, name: str,
                    fields=None, meter=None):
    """Drive one full-width path: run ``cfg`` with the kernels once as a
    warm-up, zero the launch counts, run it again, read the counts, and
    hold the two kernel runs equal; then run ``plain_cfg`` — the same path
    — on the plain versions and hold the two bit for bit (outputs and the
    per-lane result ``fields``, by default every DBSCANResult field).
    ``meter`` is filled by the counted run.  Returns (outputs, trace,
    launches, plain trace)."""
    fields = fields or dbscan.DBSCANResult._fields
    run = ddc.make_ddc_fn(cfg, LANES, device="cuda", meter=meter)
    tw: dict = {}
    out_w = run(pts, mask, tw)  # warm-up
    torch.cuda.synchronize()
    if meter is not None:
        meter.reset()
    ops.reset_launch_counts()
    tk: dict = {}
    out_k = run(pts, mask, tk)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"{name} run: phase1 {tk['phase1_s']:.4f}s phase2 {tk['phase2_s']:.4f}s "
        f"launches {launches} paths {[p['path'] for p in tk['paths']]}")
    diff = differences(torch, ddc, dbscan, out_k, out_w, tk, tw, fields)
    if diff:
        raise RuntimeError(f"{name}: two kernel runs differ in {diff}")
    ops.FORCE = "ref"
    try:
        tr: dict = {}
        out_r = ddc.make_ddc_fn(plain_cfg, LANES, device="cuda")(pts, mask, tr)
        torch.cuda.synchronize()
    finally:
        ops.FORCE = None
    if ops.launch_counts() != launches:
        raise RuntimeError(f"{name}: the plain run launched a kernel")
    diff = differences(torch, ddc, dbscan, out_k, out_r, tk, tr, fields)
    if diff or tk["paths"] != tr["paths"]:
        raise RuntimeError(f"{name}: kernel run differs from the plain run in {diff}, "
                           f"paths {tk['paths']} vs {tr['paths']}")
    return out_k, tk, launches, tr


def check_output(torch, cfg, out) -> int:
    glabels, gcs, my_map = out
    c = cfg.max_clusters
    if glabels.shape != (FULL_N,) or my_map.shape != (LANES * c,) \
            or not bool(torch.isfinite(gcs.contours).all()) \
            or int(glabels.min()) < -1 or int(glabels.max()) >= c:
        raise RuntimeError("full-width output has the wrong shape or range")
    n_global = int(gcs.valid.sum())
    if n_global < 1 or bool(gcs.overflow):
        raise RuntimeError(f"full-width run found {n_global} clusters, overflow "
                           f"{bool(gcs.overflow)}")
    return n_global


def tensor_bytes(t) -> int:
    """Bytes of the distinct elements ``t`` addresses: an axis broadcast
    with stride 0 is read once."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def bf16_tol(want) -> tuple[float, float]:
    """(rtol, atol) of a bf16 kernel output against its plain version."""
    return LM_KERNEL_BF16_RTOL, LM_KERNEL_BF16_ATOL_FRAC * float(want.double().abs().max())


def within(torch, got, want, tol) -> bool:
    """|got − want| <= atol + rtol·|want| everywhere, in float64, and the
    same shape and dtype; ``tol`` = (rtol, atol)."""
    rtol, atol = tol
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    g, w = got.double(), want.double()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def kernel_entry(torch, name, src, replaces, shape, kern, plain, bound_ms, bound_by,
                 launches, launched_in, library=None, tol=None, extra=None) -> dict:
    """Hold one kernel against its plain version on the same inputs (bit
    for bit, or within ``tol`` = (rtol, atol), or ``tol(plain output)``),
    and time both, and ``library`` (one PyTorch call computing the same
    function, timed only) where there is one."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    exact = same(torch, got, want)
    err = float((got.double() - want.double()).abs().max())
    tol = tol(want) if callable(tol) else tol
    if not (exact if tol is None else within(torch, got, want, tol)):
        raise RuntimeError(f"{name}: kernel differs from its plain version "
                           f"(max abs err {err}, tolerance {tol or 0.0})")
    entry = {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
        "shape": shape, "launches": launches, "launched_in": launched_in, "exact": exact,
        "max_abs_err": err, "max_abs_plain": float(want.double().abs().max()),
        "tolerance": list(tol) if tol else 0.0,
        "ms": median_ms(torch, kern, 20, per=10), "plain_ms": median_ms(torch, plain, 3),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None if library is None else median_ms(torch, library, 20, per=10),
        **(extra or {}),
    }
    log(json.dumps(entry))
    return entry


def sweep_extra(torch, name, items, tile, bound_tests, kern) -> dict:
    """What a pair kernel's kernels-line entry adds (the counts and the
    sweeps of csrc/pair_sweep.cu): two launches bit-identical, its work
    items and the pair tests they make (items of tile² tests), beside the
    unordered pair tests its bound counts."""
    return {**two_launches(torch, name, kern), "work_items": items, "tile": tile,
            "kernel_tests": items * tile * tile, "bound_tests": bound_tests}


def two_launches(torch, name, kern) -> dict:
    """Two launches on the main path's inputs must be bit-identical."""
    if not same(torch, kern(), kern()):
        raise RuntimeError(f"{name}: two launches on the main path's inputs differ")
    return {"two_launches_identical": True}


def slot_counts(torch, counts, valid, v):
    """Real vertices per slot (0 for an invalid slot), as the kernel reads them."""
    return torch.where(valid, counts.clamp(0, v), 0).to(torch.int64)


def contour_extra(torch, name, counts, valid, v, kern) -> dict:
    """What B5's square entry adds: two launches identical, its work items
    (each unordered pair of distinct valid slots once; a valid slot's own
    entry is 0 with no test), the vertex-pair tests they make and the real
    vertices of the valid slots, which are also what its bound counts."""
    c = slot_counts(torch, counts, valid, v)
    c = c[c > 0]
    nv, total, sq = int(c.numel()), int(c.sum()), int((c * c).sum())
    return {**two_launches(torch, name, kern), "valid_slots": nv, "valid_vertices": total,
            "work_items": nv * (nv - 1) // 2, "bound_tests": (total * total - sq) // 2}


def replace_lanes(ddc, batch, other, lanes):
    """``batch`` with the ClusterSets of ``lanes`` taken from ``other``."""
    return ddc.stack_clustersets([ddc.lane_set(other if i in lanes else batch, i)
                                  for i in range(batch.valid.shape[0])])


def delta_equal(torch, a, b) -> bool:
    """Two merge_delta results: the matrix bit for bit, the maps and every
    field of the merged ClusterSet equal."""
    (ma, pa, da), (mb, pb, db) = a, b
    return same(torch, da, db) and same(torch, pa, pb) and all(
        same(torch, x, y) for x, y in zip(ma, mb))


def delta_full_width(torch, ddc, ops, cfg, batch, pts2, mask):
    """The delta merge (``merge_delta``, the stream engine's phase 2) at full
    width: the default path's batch with lanes ``DELTA_DIRTY`` replaced by
    the ClusterSets of a second full-width local phase on other points
    (``pts2``, the same ``DDCConfig``), folded into the old batch's cached
    matrix.  The counted run patches the three lanes (launch counts zeroed
    just before, read just after: one ``cross_min_d2``); it, one dirty lane
    (``update_pair_d2``) and an exclude case must each equal the rebuild
    (``pair_d2=None``) in the matrix bit for bit, the maps and the merged
    set, and the same path on the plain versions; the square and the
    rectangular rebuilds must be bit-identical.  Device times of the
    patches and the rebuilds.  Returns (the line, the three-lane batch, the
    counted run's launches)."""
    t2: dict = {}
    ddc.make_ddc_fn(cfg, LANES, device="cuda")(pts2, mask, t2)
    other = t2["batch"]
    new3 = replace_lanes(ddc, batch, other, DELTA_DIRTY)
    new1 = replace_lanes(ddc, batch, other, (DELTA_ONE,))
    cached = ddc.contour_pair_d2(batch, cfg)
    exclude = torch.zeros(LANES, dtype=torch.bool, device="cuda")
    exclude[DELTA_EXCLUDE] = True
    dirty3 = list(DELTA_DIRTY)
    ddc.merge_delta(new3, cached.clone(), dirty3, cfg)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    patched = ddc.merge_delta(new3, cached.clone(), dirty3, cfg)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches["cross_min_d2"] != 1 or launches["contour_min_d2"] != 0:
        raise RuntimeError(f"the delta merge launched {launches}, expected one cross_min_d2")
    cases = {"three_dirty": (new3, dirty3, None), "one_dirty": (new1, [DELTA_ONE], None),
             "exclude": (new3, dirty3, exclude)}
    out = {}
    for name, (b, dirty, ex) in cases.items():
        got = patched if name == "three_dirty" else ddc.merge_delta(b, cached.clone(), dirty,
                                                                     cfg, ex)
        rebuild = ddc.merge_delta(b, None, None, cfg, ex)
        ops.FORCE = "ref"
        try:
            plain = ddc.merge_delta(b, cached.clone(), dirty, cfg, ex)
        finally:
            ops.FORCE = None
        torch.cuda.synchronize()
        changed = int((got[2] != cached).sum())
        if not delta_equal(torch, got, rebuild) or not delta_equal(torch, got, plain) \
                or changed == 0:
            raise RuntimeError(f"delta_full_width {name}: the patched merge differs from the "
                               f"rebuild or from the plain run ({changed} entries changed)")
        out[name] = {"dirty": dirty, "exclude": None if ex is None else [DELTA_EXCLUDE],
                     "entries_changed": changed, "n_clusters": int(got[0].valid.sum()),
                     "maps_excluded_all_minus_one": None if ex is None else bool(
                         (got[1][DELTA_EXCLUDE] == -1).all()),
                     "equals_rebuild": True, "equals_plain": True}
    square = ddc.contour_pair_d2(new3, cfg)
    if not same(torch, square, ddc.contour_pair_d2_exact(new3, cfg)) \
            or not same(torch, ddc.merge_many(new3, cfg)[1], patched[1]):
        raise RuntimeError("delta_full_width: the square and rectangular matrices differ")
    dev_dirty = torch.tensor(dirty3, dtype=torch.int64, device="cuda")
    work = cached.clone()
    times = {
        "patch_three_ms": median_ms(
            torch, lambda: ddc.update_pair_d2_many(work, new3, dev_dirty, cfg), 20, per=10),
        "patch_one_ms": median_ms(
            torch, lambda: ddc.update_pair_d2(work, new1, DELTA_ONE, cfg), 20, per=10),
        "rebuild_rectangular_ms": median_ms(
            torch, lambda: ddc.contour_pair_d2_exact(new3, cfg), 20, per=10),
        "rebuild_square_ms": median_ms(
            torch, lambda: ddc.contour_pair_d2(new3, cfg), 20, per=10)}
    line = {"lanes": LANES, "slots": int(new3.valid.numel()), "second_seed": DELTA_SEED,
            "launches": launches, **out, "square_equals_rectangular": True,
            "valid_slots": int(new3.valid.sum()), **times}
    return line, new3, launches


def phase1_bench(torch, np, dbscan, ops, spatial, dev) -> list[dict]:
    """BENCH_phase1.json's scenarios on the card: committed pair counts,
    and sparse == dense DBSCAN where the bench ran the clustering."""
    bench = json.loads((ROOT / "BENCH_phase1.json").read_text())
    rows = []
    for row in bench["rows"]:
        n, bt, eps = row["n"], row["bt"], row["eps"]
        if row["scenario"] == "uniform":
            pts = np.random.default_rng(0).uniform(0, 1, (n, 2)).astype(np.float32)
        elif row["scenario"] == "clustered":
            pts = spatial.make_clustered(n, seed=0)
        else:
            pts = spatial.make_worm(n, seed=0)
        x = torch.as_tensor(pts, device=dev)
        m = torch.ones(n, dtype=torch.bool, device=dev)
        sp, sm, _ = dbscan.spatial_sort(x, m, bt)
        pairs = ops.build_tile_pairs(sp, sm, eps, bt=bt)
        out = {"scenario": row["scenario"], "n": n, "n_active_pairs": int(pairs.n_active),
               "active_frac": round(float(pairs.frac), 4)}
        if (out["n_active_pairs"], out["active_frac"]) != (row["n_active_pairs"],
                                                           row["active_frac"]):
            raise RuntimeError(f"phase1_bench {out}: committed {row['n_active_pairs']}, "
                               f"{row['active_frac']}")
        if n in BENCH_SWEEP_NS:
            timed = {}
            for label, kw in (("dense", dict(block_sparse="never")),
                              ("sparse", dict(block_sparse="always", bt=bt,
                                              dense_fallback_frac=1.0))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res, path = dbscan.dbscan_traced(x, m, eps, 5, **kw)
                torch.cuda.synchronize()
                timed[label] = (res, path, time.perf_counter() - t0)
            (dres, _, d_s), (sres, spath, s_s) = timed["dense"], timed["sparse"]
            if spath["path"] != "sparse" or not same(torch, dres.labels, sres.labels) \
                    or not same(torch, dres.core, sres.core) \
                    or int(sres.n_clusters) != row["n_clusters"] \
                    or int(dres.n_clusters) != row["n_clusters"]:
                raise RuntimeError(f"phase1_bench {out}: sparse DBSCAN differs from dense "
                                   f"or from the committed {row['n_clusters']} clusters")
            out.update(n_clusters=int(sres.n_clusters), sweeps_sparse=int(sres.n_sweeps),
                       sweeps_dense=int(dres.n_sweeps), sparse_s=s_s, dense_s=d_s,
                       sparse_equals_dense=True)
        rows.append(out)
    return rows


def phase2_bench(np, ddc, spatial, dev) -> dict:
    """BENCH_phase2.json's 60 rows on the card: each row's layout and
    schedule through make_ddc_fn with a CommMeter; the meter's four
    columns, the global cluster count and the match with ddc_host must
    equal the committed ones."""
    bench = json.loads((ROOT / "BENCH_phase2.json").read_text())
    keys = ("merge_steps", "merge_slots", "bytes_exchanged", "collectives", "n_clusters",
            "matches_host")
    layouts, hosts, rows = {}, {}, 0
    t0 = time.perf_counter()
    for row in bench["rows"]:
        name, k = row["layout"], row["shards"]
        spec = bench["layouts"][name]
        if name not in layouts:
            layouts[name] = spatial.PHASE2_LAYOUTS[name]["make"](spec["n"])
        pts = layouts[name]
        if (name, k) not in hosts:
            hosts[name, k] = ddc.ddc_host(pts, k, spec["eps"], spec["min_pts"],
                                          contour="grid")[0]
        cfg = ddc.DDCConfig(eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
                            max_verts=spec["max_verts"], max_clusters=spec["max_clusters"],
                            schedule=row["schedule"])
        meter = ddc.CommMeter()
        glabels, gcs, _ = ddc.make_ddc_fn(cfg, k, device=dev, meter=meter)(
            pts, np.ones(len(pts), bool))
        snap = meter.snapshot()
        got = {"merge_steps": snap["merge_steps"], "merge_slots": snap["merge_slots"],
               "bytes_exchanged": snap["bytes_total"], "collectives": snap["collectives"],
               "n_clusters": int(gcs.valid.sum()),
               "matches_host": ddc.same_clustering(glabels.cpu().numpy(), hosts[name, k])}
        want = {key: row[key] for key in keys}
        if got != want:
            raise RuntimeError(f"BENCH_phase2 {name} k={k} {row['schedule']}: {got} != {want}")
        rows += 1
    return {"rows": rows, "all_equal_committed": True, "columns": list(keys),
            "seconds": time.perf_counter() - t0}


def _flash_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a causal (right-aligned) or full attention row
    set sees."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(min(skv, max(0, off + r + 1)) for r in range(sq))


def lm_kernel_entries(torch, ops, ref, fa, ssd, captured: dict, launches: dict,
                      routes: dict) -> list[dict]:
    """The two LM kernels against their plain versions (the routes
    ``ops`` takes under FORCE="ref") on the inputs the main path gave its
    first layer, in bf16 as served and cast up to float32 (the float32
    build), timed beside the plain versions and, for attention,
    ``scaled_dot_product_attention``.  Bounds use the bf16 tensor-core
    rate (the inputs are bf16); ``bound_fp32_ms`` gives the float32
    CUDA-core bound.  Bytes count each distinct input element once
    (ssd_scan's c is broadcast over the heads).  Each kernel takes the
    tensor-core route on the bf16 inputs (two launches must give the same
    bits), as it did on the main path (``routes``: its launches there by
    route), and the CUDA-core route on the float32 ones; the CUDA-core
    kernel is also timed and held on the bf16 inputs (``simt``), the design
    the tensor-core route replaced there."""
    q, k, v = captured["flash_attention"]
    b, h, s, d = q.shape
    hkv = k.shape[1]
    ops_fa = b * h * _flash_pairs(s, s, True) * 4 * d      # q·k and p·v, 2d each
    bytes_fa = tensor_bytes(q) * 2 + tensor_bytes(k) + tensor_bytes(v)   # q, k, v, out
    kind = fa.route(q.dtype, d)
    if kind != "tc" or routes["flash_attention"] != {"tc": launches["flash_attention"],
                                                    "simt": 0}:
        raise RuntimeError(f"qwen3-8b's bf16 attention took route {kind}, main-path launches "
                           f"by route {routes['flash_attention']}: expected the tensor cores")
    q32, k32, v32 = q.float(), k.float(), v.float()
    before = dict(fa.route_launches)
    f32_fa = f32_check(torch, "flash_attention",
                       lambda: ops.flash_attention(q32, k32, v32, causal=True),
                       lambda: ref.flash_attention_chunked(q32, k32, v32, causal=True))
    if fa.route_launches["simt"] != before["simt"] + 1:
        raise RuntimeError("flash_attention: the float32 inputs did not take the CUDA cores")
    del q32, k32, v32

    def kern():
        return ops.flash_attention(q, k, v, causal=True)

    def plain():
        return ref.flash_attention_chunked(q, k, v, causal=True)

    def simt():
        return fa._launch("simt", q, k, v, True, None, None)

    want = plain()
    if not same(torch, kern(), kern()):
        raise RuntimeError("flash_attention: two launches on the main path's inputs differ")
    simt_out = held(torch, "flash_attention (CUDA cores, bf16)", simt(), want, bf16_tol(want))
    del want
    b_ms, b_by = bound(ops_fa, bytes_fa, PEAK_BF16)
    entries = [kernel_entry(
        torch, "flash_attention", "flash_attention_tc.cu",
        "src/repro/kernels/flash_attention.py:99", [b, h, hkv, s, d, str(q.dtype)],
        kern, plain, b_ms, b_by, launches["flash_attention"], "qwen3-8b prefill",
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        tol=bf16_tol,
        extra={"kernel_route": kind, "route_launches": routes["flash_attention"],
               "two_launches_identical": True,
               "bound_fp32_ms": bound(ops_fa, bytes_fa)[0], "operations": ops_fa,
               # p_hi and p_lo each multiply v: 1.5x the function's operations
               "tensor_core_operations": ops_fa * 3 // 2, "bytes": bytes_fa,
               "simt": {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "ms": median_ms(torch, simt, 5, per=2),
                        "max_abs_err": simt_out["max_abs_err"]},
               **f32_fa})]
    x, a, bb, c = captured["ssd_scan"]
    bsz, l, hs, dh = x.shape
    ds = bb.shape[-1]
    kind = ssd.route(x.dtype, dh, ds)
    if kind != "tc" or routes["ssd_scan"] != {"tc": launches["ssd_scan"], "simt": 0}:
        raise RuntimeError(f"mamba2-1.3b's bf16 SSD took route {kind}, main-path launches by "
                           f"route {routes['ssd_scan']}: expected the tensor cores")
    lc = ssd.CHUNK[kind]
    # The chunked form at the route's chunk, per (batch, step, head): c·b and
    # G·x over the causal half of each chunk, c·S and the state update over
    # (ds, dh).
    ops_ssd = bsz * l * hs * ((lc + 1) * (ds + dh) + 4 * ds * dh)
    # What the tensor cores issue (csrc/ssd_scan_tc.cu), per chunk and
    # (batch, head): the whole c·bᵀ, and c·S_in, G·x and the state update
    # each twice (hi and lo parts); the last chunk's state is not computed.
    n_chunks = -(-l // lc)
    tc_ops = bsz * hs * (n_chunks * (2 * lc * lc * ds + 4 * lc * ds * dh + 4 * lc * lc * dh)
                         + (n_chunks - 1) * 4 * ds * lc * dh)
    bytes_ssd = tensor_bytes(x) * 2 + tensor_bytes(a) + tensor_bytes(bb) + tensor_bytes(c)
    # Cast up as the main path hands them over: c stays a broadcast view.
    c32 = c[:, :, :1].float().expand(c.shape) if c.stride(2) == 0 else c.float()
    x32, b32 = x.float(), bb.float()
    before = dict(ssd.route_launches)
    f32_ssd = f32_check(torch, "ssd_scan", lambda: ops.ssd_scan(x32, a, b32, c32),
                        lambda: ref.ssd_scan_chunked(x32, a, b32, c32,
                                                     chunk=ops.PLAIN_SSD_CHUNK))
    if ssd.route_launches["simt"] != before["simt"] + 1:
        raise RuntimeError("ssd_scan: the float32 inputs did not take the CUDA cores")
    del x32, b32, c32

    def kern():
        return ops.ssd_scan(x, a, bb, c)

    def plain():
        return ref.ssd_scan_chunked(x, a, bb, c, chunk=ops.PLAIN_SSD_CHUNK)

    def simt():
        return ssd._launch("simt", x, a, bb, c)

    want = plain()
    if not same(torch, kern(), kern()):
        raise RuntimeError("ssd_scan: two launches on the main path's inputs differ")
    simt_out = held(torch, "ssd_scan (CUDA cores, bf16)", simt(), want, bf16_tol(want))
    del want
    b_ms, b_by = bound(ops_ssd, bytes_ssd, PEAK_BF16)
    entries.append(kernel_entry(
        torch, "ssd_scan", "ssd_scan_tc.cu", "src/repro/kernels/ssd_scan.py:78",
        [bsz, l, hs, dh, ds, str(x.dtype)], kern, plain, b_ms, b_by,
        launches["ssd_scan"], "mamba2-1.3b prefill", tol=bf16_tol,
        extra={"kernel_route": kind, "route_launches": routes["ssd_scan"],
               "two_launches_identical": True,
               "bound_fp32_ms": bound(ops_ssd, bytes_ssd)[0], "operations": ops_ssd,
               "tensor_core_operations": tc_ops, "bytes": bytes_ssd,
               "c_head_stride": c.stride(2), "chunk": lc,
               "simt": {"source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "ms": median_ms(torch, simt, 5, per=2),
                        "max_abs_err": simt_out["max_abs_err"]},
               **f32_ssd}))
    return entries


def moe_gather_entry(torch, ops, ref, captured: dict, launches: dict) -> dict:
    """The MoE dispatch gather against its plain version on the inputs
    llama4-scout's prefill gave its first MoE layer: buf and scales bit
    for bit without quantisation in bf16 (as served) and cast up to
    float32, and int8 and scales with it; timed in both modes beside
    ``index_select`` of the same rows, which leaves out the empty-slot
    mask and the quantisation.  Bound by bytes: each kept row read once,
    the ids read and buf and the scales written once."""
    from repro_torch import configs

    x, idx = captured["dispatch_gather"]
    t, d = x.shape
    s = idx.shape[0]
    kept = int((idx >= 0).sum())
    io = kept * d * x.element_size() + s * 4 + s * 4      # rows in, ids in, scales out
    copy_bytes, quant_bytes = io + s * d * x.element_size(), io + s * d
    quant_ops = kept * d * 6    # |v| and max; the division, rint, clamp at both ends
    checks = {}
    for label, xs, quant in (("bf16", x, False), ("float32", x.float(), False),
                             ("int8", x, True)):
        got, want = ops.dispatch_gather(xs, idx, quant=quant), ref.dispatch_gather(
            xs, idx, quant=quant)
        torch.cuda.synchronize()
        if not (same(torch, got[0], want[0]) and same(torch, got[1], want[1])):
            raise RuntimeError(f"dispatch_gather ({label}): kernel differs from its plain "
                               "version")
        checks[label] = True

    def library():
        return x.index_select(0, idx.clamp_min(0))

    shape = [t, d, s, str(x.dtype)]
    entry = kernel_entry(
        torch, "dispatch_gather", "moe_gather.cu", "src/repro/kernels/moe_gather.py:48", shape,
        lambda: ops.dispatch_gather(x, idx, quant=False)[0],
        lambda: ref.dispatch_gather(x, idx, quant=False)[0], *bound(0, copy_bytes),
        launches["dispatch_gather"], "llama4-scout-17b-a16e prefill and decode",
        library=library,
        extra={"bytes": copy_bytes, "kept_rows": kept, "bit_identical": checks,
               "library": "index_select (no mask, no quantisation)"})
    q = kernel_entry(
        torch, "dispatch_gather_int8", "moe_gather.cu", "src/repro/kernels/moe_gather.py:48",
        shape, lambda: ops.dispatch_gather(x, idx, quant=True)[0],
        lambda: ref.dispatch_gather(x, idx, quant=True)[0], *bound(quant_ops, quant_bytes),
        0, "none: the int8 mode is the a2a wire format (several cards)", library=library,
        extra={"bytes": quant_bytes, "operations": quant_ops})
    entry["int8"] = {k: q[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "max_abs_err", "exact", "bytes", "operations",
                                       "launches")}
    # The decode shape (4 tokens top-1 over 16 experts at capacity 1), where
    # 60 of the 64 main-path launches run: launch-bound.
    e = configs.get_config("llama4-scout-17b-a16e").n_experts
    x_dec = x[:LM_BATCH]
    idx_dec = torch.full((e,), -1, dtype=torch.int32, device=x.device)
    idx_dec[torch.arange(LM_BATCH, device=x.device) * (e // LM_BATCH)] = torch.arange(
        LM_BATCH, dtype=torch.int32, device=x.device)
    dec = ops.dispatch_gather(x_dec, idx_dec, quant=False)
    if not all(same(torch, a, b) for a, b in zip(dec, ref.dispatch_gather(x_dec, idx_dec,
                                                                          quant=False))):
        raise RuntimeError("dispatch_gather (decode shape): kernel differs from its plain "
                           "version")
    dec_bytes = LM_BATCH * d * x.element_size() + e * 8 + e * d * x.element_size()
    entry["decode"] = {"shape": [LM_BATCH, d, e, str(x.dtype)], "exact": True,
                       "ms": median_ms(torch, lambda: ops.dispatch_gather(
                           x_dec, idx_dec, quant=False), 20, per=10),
                       "bound_ms": bound(0, dec_bytes)[0], "bound_by": "bytes"}
    log(f"dispatch_gather at the decode shape: {entry['decode']}")
    return entry


def moe_gather_sweep(torch, ops, ref, dev) -> list[dict]:
    """MOE_GATHER_SWEEP in both modes: one kernel launch (counted) bit for
    bit against the plain version, and a second launch giving the same
    bits."""
    g = torch.Generator(device=dev).manual_seed(15)
    rows = []
    for case in MOE_GATHER_SWEEP:
        t, d, s, dtype, layout = case
        wide = torch.randn((t, 2 * d + 3), generator=g, device=dev).to(getattr(torch, dtype))
        x = wide[:, 3:3 + d] if layout == "strided" else wide[:, :d].contiguous()
        idx = torch.randint(-1, t, (s,), generator=g, device=dev, dtype=torch.int32)
        if layout == "empty":
            idx.fill_(-1)
        elif layout == "beyond":
            idx = torch.randint(-1, 2 * t, (s,), generator=g, device=dev, dtype=torch.int32)
        for quant in (False, True):
            before = ops.launch_counts()["dispatch_gather"]
            got = ops.dispatch_gather(x, idx, quant=quant)
            torch.cuda.synchronize()
            if ops.launch_counts()["dispatch_gather"] != before + 1:
                raise RuntimeError(f"dispatch_gather {case}: the kernel did not launch")
            want = ref.dispatch_gather(x, idx, quant=quant)
            again = ops.dispatch_gather(x, idx, quant=quant)
            if not all(same(torch, a, b) for a, b in zip(got + again, want + want)):
                raise RuntimeError(f"dispatch_gather {case} quant={quant}: kernel differs "
                                   "from its plain version or from itself")
            rows.append({"case": list(case), "quant": quant, "row_stride": x.stride(0),
                         "exact": True})
    return rows


def held(torch, what, got, want, tol) -> dict:
    """Raise unless ``got`` is within ``tol`` of ``want``; returns the
    error, the plain output's scale and the tolerance."""
    err = float((got.double() - want.double()).abs().max())
    if not within(torch, got, want, tol):
        raise RuntimeError(f"{what}: kernel differs from its plain version (max abs err "
                           f"{err}, tolerance {tol})")
    return {"max_abs_err": err, "max_abs_plain": float(want.double().abs().max()),
            "tolerance": list(tol)}


def f32_check(torch, name, kern, plain) -> dict:
    """The float32 build of an LM kernel against its plain version, within
    LM_KERNEL_F32_TOL."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    out = held(torch, f"{name} (float32)", got, want, LM_KERNEL_F32_TOL[name])
    return {f"f32_{k}": v for k, v in out.items()}


def lm_kernel_sweep(torch, ops, ref, fa, ssd, dev) -> list[dict]:
    """FLASH_SWEEP and SSD_SWEEP: each case from a seeded generator, one
    kernel launch (counted, and on the route ``fa.route`` / ``ssd.route``
    picks) against the plain version tests/test_kernels.py holds it to
    (exact attention, sequential SSD), float32 at LM_KERNEL_F32_TOL and
    bf16 at ``bf16_tol``; a second launch must give the same bits."""
    g = torch.Generator(device=dev).manual_seed(14)

    def randn(shape, bf16):
        t = torch.randn(shape, generator=g, device=dev)
        return t.bfloat16() if bf16 else t

    def hold(name, case, kern, plain, bf16, kernel_route):
        before = ops.launch_counts()[name]
        counts = (fa if name == "flash_attention" else ssd).route_launches
        routes = dict(counts)
        got = kern()
        torch.cuda.synchronize()
        if ops.launch_counts()[name] != before + 1:
            raise RuntimeError(f"{name} {case}: the kernel did not launch")
        if counts[kernel_route] != routes[kernel_route] + 1:
            raise RuntimeError(f"{name} {case}: the {kernel_route} route did not launch")
        want = plain()
        out = held(torch, f"{name} {case}", got, want,
                   bf16_tol(want) if bf16 else LM_KERNEL_F32_TOL[name])
        if not same(torch, got, kern()):
            raise RuntimeError(f"{name} {case}: two kernel launches differ")
        return {"kernel": name, "case": list(case), "kernel_route": kernel_route, **out}

    def heads(b, n, s, d, bf16, layout):
        if layout == "bshd":  # (b, s, n, d) memory, seen as (b, n, s, d)
            return randn((b, s, n, d), bf16).transpose(1, 2)
        return randn((b, n, s, d), bf16)

    rows = []
    for case in FLASH_SWEEP:
        b, h, hkv, sq, skv, d, causal, window, bf16, layout = case
        q, k, v = (heads(b, n, s, d, bf16, layout) for n, s in ((h, sq), (hkv, skv), (hkv, skv)))
        rows.append(hold("flash_attention", case,
                         lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
                         lambda: ref.flash_attention(q, k, v, causal=causal, window=window),
                         bf16, fa.route(q.dtype, d)))
    for case in SSD_SWEEP:
        b, l, h, dh, ds, bf16, layout = case
        if layout == "mamba":  # as layers._mamba_ssd_inputs hands them over
            xbc = randn((b, l, h * dh + 2 * ds), bf16)
            x = xbc[..., :h * dh].reshape(b, l, h, dh)
            bb = xbc[..., h * dh:h * dh + ds][:, :, None, :].expand(b, l, h, ds) * 0.5
            c = xbc[..., h * dh + ds:][:, :, None, :].expand(b, l, h, ds)
        else:
            x, bb, c = (randn((b, l, h, n), bf16) for n in (dh, ds, ds))
        a = -0.1 * randn((b, l, h), False).abs()
        rows.append(hold("ssd_scan", case, lambda: ops.ssd_scan(x, a, bb, c),
                         lambda: ref.ssd_scan(x, a, bb, c), bf16, ssd.route(x.dtype, dh, ds)))
    return rows


def long_prefill_attention(torch, ops, fa, dev) -> dict:
    """flash_attention at prefill_32k's length: one sequence, one qwen3-8b
    layer's q/k/v shapes (random bf16), the kernel (the tensor-core route),
    the CUDA-core kernel and SDPA timed, not gated."""
    g = torch.Generator(device=dev).manual_seed(32)
    h, hkv, d = 32, 8, 128
    q = torch.randn((1, h, LONG_PREFILL, d), generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn((1, hkv, LONG_PREFILL, d), generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn((1, hkv, LONG_PREFILL, d), generator=g, device=dev, dtype=torch.bfloat16)
    ops_fa = h * _flash_pairs(LONG_PREFILL, LONG_PREFILL, True) * 4 * d
    before = fa.route_launches["tc"]
    out = {"shape": [1, h, hkv, LONG_PREFILL, d, "bfloat16"],
           "ms": median_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True), 5, per=3),
           "simt_ms": median_ms(torch, lambda: fa._launch("simt", q, k, v, True, None, None), 1),
           "sdpa_ms": median_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True), 5, per=3),
           "bound_ms": ops_fa / PEAK_BF16 * 1e3, "bound_fp32_ms": ops_fa / PEAK_FP32 * 1e3}
    if fa.route_launches["tc"] == before:
        raise RuntimeError("the 32k attention timing did not launch the tensor-core kernel")
    return out


def profile_fn(torch, fn, wall_s: float, top: int = 6, require=()) -> dict:
    """Device time by kernel over one call of ``fn`` under torch.profiler,
    and its share of ``wall_s`` (the same work's unprofiled wall time).
    Kernels run on one stream, so their times do not overlap and their sum
    is the busy time.  Raises if a kernel named in ``require`` did not run
    (when the profiler saw the device)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    if not rows:
        return {"device_ms": "not measured", "wall_s": wall_s}
    missing = [k for k in require if k not in rows]
    if missing:
        raise RuntimeError(f"profile: kernels {missing} did not run: {sorted(rows)}")
    device_ms = sum(ms for ms, _ in rows.values())
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": wall_s, "device_ms": device_ms, "busy_share": device_ms / 1e3 / wall_s,
            "device_calls": sum(c for _, c in rows.values()),
            "top": [{"name": k, "ms": ms, "calls": c} for k, (ms, c) in ranked]}


def cast_model(torch, T, cfg, model, dtype):
    """A copy of ``model`` with every parameter cast to ``dtype``."""
    out = T.LM(cfg, None, device=model.embed.device, dtype=dtype)
    for (name, dst), (name_src, src) in zip(out.named_parameters(), model.named_parameters()):
        assert name == name_src
        dst.copy_(src)
    return out


def forced_run(torch, ops, engine, cfg, scfg, model, prompt, toks, *, plain: bool):
    """Prefill ``prompt``, then decode teacher-forced on ``toks``: each
    step's logits (prefill's first), with the kernels or (``plain``) the
    plain versions, which must launch no kernel; and the prefill's wall
    time."""
    before = ops.launch_counts()
    ops.FORCE = "ref" if plain else None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, pos = engine.build_prefill(cfg, scfg)(model, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = [lg]
        decode = engine.build_decode(cfg, scfg)
        for i in range(toks.shape[1] - 1):
            lg, cache = decode(model, toks[:, i:i + 1], cache, pos + i)
            out.append(lg)
        torch.cuda.synchronize()
    finally:
        ops.FORCE = None
    if plain and ops.launch_counts() != before:
        raise RuntimeError(f"{cfg.name}: the plain run launched a kernel")
    return out, prefill_s


def lm_launch_plan(cfg) -> dict[str, int]:
    """The launches one greedy_generate of LM_STEPS tokens makes, by kernel:
    flash_attention once per attention layer and ssd_scan once per Mamba
    layer, in prefill only; dispatch_gather once per MoE layer in prefill
    and in each of the LM_STEPS − 1 decode steps."""
    kinds = cfg.layer_kinds()

    def layers(pred) -> int:
        return cfg.n_groups * sum(1 for kind, is_moe in kinds if pred(kind, is_moe))

    return {"flash_attention": layers(lambda kind, _: kind == "attn"),
            "ssd_scan": layers(lambda kind, _: kind == "mamba"),
            "dispatch_gather": layers(lambda _, is_moe: is_moe) * LM_STEPS}


@contextlib.contextmanager
def record_routes(L):
    """While active, every MoE layer's routing (its top-k experts and which
    token-copies it kept) is appended to the yielded list, in call order:
    prefill's MoE layers, then each decode step's."""
    calls, orig = [], L._route

    def route(probs, k, capacity):
        r = orig(probs, k, capacity)
        calls.append((r.topi, r.keep))
        return r

    L._route = route
    try:
        yield calls
    finally:
        L._route = orig


@contextlib.contextmanager
def replay_routes(L, log: list):
    """While active, every MoE layer routes by the next (topi, keep) of
    ``log`` (another run's route log, call for call), its gates from its
    own probabilities (``layers.route_given``); what it routes is appended
    to the yielded list.  Raises if a call does not line up with the log;
    the caller checks that every logged call was replayed."""
    calls, orig, logged = [], L._route, iter(log)

    def route(probs, k, capacity):
        step = next(logged, None)
        if step is None or step[0].shape != (probs.shape[0], k):
            raise RuntimeError("replayed routing: the MoE calls do not line up with the log")
        r = L.route_given(probs, step[0], capacity)
        if not r.keep.equal(step[1]):
            raise RuntimeError("replayed routing: the replayed choice keeps other copies")
        calls.append((r.topi, r.keep))
        return r

    L._route = route
    try:
        yield calls
    finally:
        L._route = orig


def route_diffs(torch, a: list, b: list, n_moe: int) -> dict:
    """Tokens routed to other experts in run ``b`` than in run ``a`` (the
    same inputs' route logs), in prefill and in decode."""
    if len(a) != len(b) or any(x[0].shape != y[0].shape for x, y in zip(a, b)):
        raise RuntimeError("two runs' route logs do not align")
    diff = [int((x[0] != y[0]).any(dim=1).sum()) for x, y in zip(a, b)]
    return {"prefill": sum(diff[:n_moe]), "decode": sum(diff[n_moe:]),
            "decisions": sum(int(x[0].shape[0]) for x in a)}


def route_drops(log: list, n_moe: int) -> dict:
    """Token-copies dropped at capacity, per MoE layer: in prefill, and
    summed over the decode steps."""
    per_call = [int((~keep).sum()) for _, keep in log]
    return {"prefill": per_call[:n_moe],
            "decode": [sum(per_call[n_moe + i::n_moe]) for i in range(n_moe)]}


def route_counts(fa, ssd) -> dict:
    """Launches so far by kernel and route, of the two LM kernels that have
    a tensor-core and a CUDA-core route."""
    return {"flash_attention": dict(fa.route_launches), "ssd_scan": dict(ssd.route_launches)}


def lm_phase(torch, dev, card: str) -> tuple[dict, dict, dict]:
    """Serve each LM_ARCHS model at full width, at full depth or cut to
    LM_LAYERS (see the module docstring), and print its numbers.  Returns
    ({kernel: main-path launches}, {kernel: first-layer inputs}, {model:
    {kernel: main-path launches by route}} for flash_attention and
    ssd_scan)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmuls must run in IEEE float32 (TF32 off)")
    launches_by_kernel, captured, lm_routes = {}, {}, {}
    for arch, kname in LM_ARCHS.items():
        published = configs.get_config(arch)
        cfg = dataclasses.replace(published, n_layers=LM_LAYERS.get(arch, published.n_layers))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                              dtype=torch.bfloat16)
        prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        scfg = engine.ServeConfig(max_len=LM_PROMPT + LM_STEPS)
        n_params = sum(p.numel() for p in model.parameters())

        # Two kernel runs: the first counted, the second (warm, so its times
        # are the ones reported) captures the first layer's kernel inputs
        # and logs the MoE routing; both must agree bit for bit.
        runs = []
        for i in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            orig = getattr(ops, kname)
            if i == 1:
                def capture(*args, _orig=orig, _name=kname, **kw):
                    captured.setdefault(_name, args)
                    return _orig(*args, **kw)
                setattr(ops, kname, capture)
            ops.reset_launch_counts()
            try:
                tr: dict = {}
                with record_routes(L) as routes_k:
                    toks = engine.greedy_generate(cfg, model, prompt, LM_STEPS, scfg, trace=tr)
                torch.cuda.synchronize()
            finally:
                setattr(ops, kname, orig)
            runs.append((toks, tr, ops.launch_counts(), route_counts(fa, ssd),
                         torch.cuda.max_memory_allocated(dev)))
        (toks, tr, launches, routes, peak), (toks2, tr2, _, _, _) = runs
        plan = lm_launch_plan(cfg)
        want = {k: plan.get(k, 0) for k in launches}
        log(f"{arch}: launches {launches}, routes {routes}, prefill "
            f"{tr['prefill_s']:.4f}s, decode {tr['decode_s']:.4f}s")
        if launches != want:
            raise RuntimeError(f"{arch}: launches {launches}, expected {want} (attention and "
                               "SSD once per layer in prefill, the MoE gather once per MoE "
                               "layer in prefill and in every decode step)")
        # bf16 weights: every attention and SSD launch takes the route its
        # shape gets in bf16 (the tensor cores at attention's d 64 and 128 and
        # at the SSD's (dh, ds) = (64, 128)).
        want_routes = {k: {"tc": 0, "simt": 0} for k in routes}
        want_routes["flash_attention"][fa.route(torch.bfloat16, cfg.head_dim)] += \
            plan["flash_attention"]
        want_routes["ssd_scan"][ssd.route(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state)] += \
            plan["ssd_scan"]
        if routes != want_routes:
            raise RuntimeError(f"{arch}: launches by route {routes}, expected {want_routes}")
        if not same(torch, toks, toks2) or not all(
                same(torch, a, b) for a, b in zip(tr["logits"], tr2["logits"])):
            raise RuntimeError(f"{arch}: two kernel runs differ")
        if toks.shape != (LM_BATCH, LM_STEPS) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab or not all(
                    bool(torch.isfinite(lg).all()) for lg in tr["logits"]):
            raise RuntimeError(f"{arch}: tokens or logits out of range")

        # One more prefill and one decode step under the profiler: device
        # time by kernel.
        prof = {"prefill": profile_fn(torch, lambda: engine.build_prefill(cfg, scfg)(
            model, prompt), tr2["prefill_s"])}
        _, cache_p, pos_p = engine.build_prefill(cfg, scfg)(model, prompt)
        prof["decode_step"] = profile_fn(torch, lambda: engine.build_decode(cfg, scfg)(
            model, toks[:, :1], cache_p, pos_p), tr2["decode_s"] / (LM_STEPS - 1))
        del cache_p

        # The plain run of the same path, teacher-forced on the kernel run's
        # tokens, in bf16 and routed by the kernel run's decisions (replayed
        # from its route log, the gates from the plain run's own
        # probabilities): where the two bf16 runs would route a token
        # differently, the bf16 gate would measure that flip, not the
        # kernel.  For a MoE model the plain run is also made unreplayed,
        # to report how often it routes otherwise.  Then both runs again
        # with the weights in float32, each logging its own routing, call
        # for call beside the kernel run's.
        with replay_routes(L, routes_k) as routes_p:
            plain, plain_prefill_s = forced_run(torch, ops, engine, cfg, scfg, model, prompt,
                                                toks, plain=True)
        if len(routes_p) != len(routes_k):
            raise RuntimeError(f"{arch}: the replayed plain run made {len(routes_p)} MoE calls, "
                               f"the kernel run {len(routes_k)}")
        plain_u, routes_u = plain, routes_p
        if routes_k:
            with record_routes(L) as routes_u:
                plain_u, _ = forced_run(torch, ops, engine, cfg, scfg, model, prompt, toks,
                                        plain=True)
        model32 = cast_model(torch, T, cfg, model, torch.float32)
        before32 = route_counts(fa, ssd)
        with record_routes(L) as routes_k32:
            kern32, _ = forced_run(torch, ops, engine, cfg, scfg, model32, prompt, toks,
                                   plain=False)
        routes32 = {k: {r: n - before32[k][r] for r, n in v.items()}
                    for k, v in route_counts(fa, ssd).items()}
        if routes32 != {k: {"tc": 0, "simt": plan[k]} for k in routes32}:
            raise RuntimeError(f"{arch}: the float32 run's launches by route {routes32}: "
                               "float32 must stay on the CUDA cores")
        with record_routes(L) as routes_p32:
            plain32, _ = forced_run(torch, ops, engine, cfg, scfg, model32, prompt, toks,
                                    plain=True)
        del model32
        torch.cuda.empty_cache()
        moe = {}
        if routes_k:
            n_moe = len(routes_k) // LM_STEPS
            moe = {"capacity_factor": cfg.capacity_factor, "moe_layers": n_moe,
                   "dropped": route_drops(routes_k, n_moe),
                   "dropped_plain_unreplayed": route_drops(routes_u, n_moe),
                   "route_diffs_bf16": route_diffs(torch, routes_k, routes_p, n_moe),
                   "route_diffs_bf16_unreplayed": route_diffs(torch, routes_k, routes_u, n_moe),
                   "route_diffs_f32": route_diffs(torch, routes_k32, routes_p32, n_moe),
                   "route_diffs_bf16_vs_f32": route_diffs(torch, routes_p32, routes_u, n_moe)}
            log(f"{arch}: MoE routing {moe}")
            if moe["route_diffs_bf16"]["prefill"] or moe["route_diffs_bf16"]["decode"]:
                raise RuntimeError(f"{arch}: the replayed plain run routes otherwise: "
                                   f"{moe['route_diffs_bf16']}")
            f32_diffs = moe["route_diffs_f32"]
            if f32_diffs["prefill"] or f32_diffs["decode"]:
                raise RuntimeError(f"{arch}: the float32 kernel run routes tokens to other "
                                   f"experts than the plain run: {f32_diffs}")
        del routes_k, routes_p, routes_u, routes_k32, routes_p32

        def rms(a, b):
            return float((a.double() - b.double()).pow(2).mean().sqrt())

        errs = [float((a.double() - b.double()).abs().max()) for a, b in zip(tr["logits"], plain)]
        errs32 = [float((a.double() - b.double()).abs().max()) for a, b in zip(kern32, plain32)]
        rms_kp = [rms(a, b) for a, b in zip(tr["logits"], plain)]
        rms_p32 = [rms(a, b) for a, b in zip(plain, plain32)]
        rms_k32 = [rms(a, b) for a, b in zip(tr["logits"], plain32)]
        rms_ku = [rms(a, b) for a, b in zip(tr["logits"], plain_u)]
        rms_u32 = [rms(a, b) for a, b in zip(plain_u, plain32)]
        scale = max(float(p.double().abs().max()) for p in plain)
        agree = sum(int((torch.argmax(p[..., :cfg.vocab], -1) == toks[:, i]).sum())
                    for i, p in enumerate(plain))
        log(f"{arch}: float32 kernel vs plain max abs err per step {errs32}; bf16 kernel vs "
            f"plain max abs {errs}, RMS {rms_kp}, bf16 plain vs float32 plain RMS {rms_p32} "
            f"(max |logit| {scale}); greedy agreement {agree}/{toks.numel()}")
        if not all(within(torch, a, b, LM_F32_TOL) for a, b in zip(kern32, plain32)):
            raise RuntimeError(f"{arch}: float32 kernel run differs from the plain run beyond "
                               f"{LM_F32_TOL}: {errs32}")
        if not all(kp <= LM_BF16_NOISE * p32 for kp, p32 in zip(rms_kp, rms_p32)):
            raise RuntimeError(f"{arch}: bf16 kernel run differs from the plain run by more "
                               f"than {LM_BF16_NOISE} x bf16's own error: {rms_kp} vs {rms_p32}")
        launches_by_kernel[kname] = launches[kname]
        lm_routes[arch] = routes
        decode_tokens = LM_BATCH * (LM_STEPS - 1)
        numbers = {
            "card": card, "layers": cfg.n_layers, "published_layers": published.n_layers,
            "d_model": cfg.d_model,
            "params": n_params, "param_dtype": "bfloat16", "batch": LM_BATCH,
            "prompt": LM_PROMPT, "steps": LM_STEPS, "max_len": scfg.max_len,
            "init_s": init_s, "prefill_s": tr2["prefill_s"],
            "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / tr2["prefill_s"],
            "decode_s": tr2["decode_s"],
            "decode_ms_per_token": tr2["decode_s"] / (LM_STEPS - 1) * 1e3,
            "decode_tokens_per_s": decode_tokens / tr2["decode_s"],
            "first_run_prefill_s": tr["prefill_s"], "first_run_decode_s": tr["decode_s"],
            "plain_prefill_s": plain_prefill_s, "peak_mem_gb": peak / 1e9,
            "launches": launches, "flash_attention_routes": routes["flash_attention"],
            "flash_attention_routes_f32": routes32["flash_attention"],
            "ssd_scan_routes": routes["ssd_scan"], "ssd_scan_routes_f32": routes32["ssd_scan"],
            "two_runs_identical": True, "profile": prof,
            "f32_tolerance": list(LM_F32_TOL), "f32_max_abs_err": errs32,
            "bf16_noise_factor": LM_BF16_NOISE, "bf16_max_abs_err": errs,
            "bf16_rms_kernel_vs_plain": rms_kp, "bf16_rms_plain_vs_f32": rms_p32,
            "bf16_rms_kernel_vs_f32": rms_k32, "bf16_plain_routes": "replayed from the kernel run",
            **({"bf16_rms_kernel_vs_plain_unreplayed": rms_ku,
                "bf16_rms_plain_unreplayed_vs_f32": rms_u32} if plain_u is not plain else {}),
            "max_abs_logit": scale,
            "greedy_agreement": [agree, toks.numel()], "first_tokens": toks[0, :8].tolist(),
            **moe}
        print(json.dumps({"lm_serve": {arch: numbers}}), flush=True)
        del model, tr, tr2, runs, toks, toks2, plain, plain_u, kern32, plain32
        torch.cuda.empty_cache()
    return launches_by_kernel, captured, lm_routes


class FrozenSource:
    """A query tier's snapshot source that serves one published view."""

    def __init__(self, snap):
        self.snap = snap

    def snapshot(self):
        return self.snap

    def read_snapshot(self):
        return self.snap


def facade_model(torch, T, cfg_kw: dict, pts, dev):
    """Fit ``DDC(DDCConfig(**cfg_kw))`` on ``pts`` on ``dev`` and read its
    labels (the lazy refit).  Returns (model, labels, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = T.DDC(T.DDCConfig(**cfg_kw), device=dev).fit(pts)
    labels = model.labels_
    torch.cuda.synchronize()
    return model, labels, time.perf_counter() - t0


def schedule_check(torch, np, ddc, pts, dev) -> dict:
    """The three schedules through the facade (``backend="jit"``) at full
    width on ``UNCUT``, where no local or merged contour fills max_verts,
    no cluster budget overflows and the data holds at least
    ``UNCUT_MIN_CLUSTERS`` global clusters: the clusterings must be the
    same and the cluster counts equal."""
    from repro_torch import ddc as T

    out = {}
    for sched in ("sync", "async", "tree"):
        model, labels, wall = facade_model(
            torch, T, dict(UNCUT, backend="jit", shards=LANES, schedule=sched), pts, dev)
        tr = model.backend.last_trace
        gcs = tr["gcs"]
        out[sched] = {"labels": labels, "n_clusters": int(gcs.valid.sum()),
                      "facade_clusters": model.n_clusters_,
                      "max_local_count": int(tr["batch"].counts.max()),
                      "max_merged_count": int(gcs.counts.max()),
                      "overflow": bool(gcs.overflow) or bool(tr["batch"].overflow.any()),
                      "phase1_s": tr["phase1_s"], "phase2_s": tr["phase2_s"], "fit_s": wall}
        log(f"schedule check {sched}: {({k: v for k, v in out[sched].items() if k != 'labels'})}")
        o = out[sched]
        if max(o["max_local_count"], o["max_merged_count"]) >= UNCUT["max_verts"] \
                or o["overflow"]:
            raise RuntimeError(f"schedule check ({sched}): a contour fills max_verts "
                               f"{UNCUT['max_verts']} or a budget overflows: {o}")
        if o["n_clusters"] < UNCUT_MIN_CLUSTERS or o["facade_clusters"] != o["n_clusters"]:
            raise RuntimeError(f"schedule check ({sched}): {o['n_clusters']} global "
                               f"clusters, need at least {UNCUT_MIN_CLUSTERS}")
        if o["n_clusters"] != out["sync"]["n_clusters"] \
                or not ddc.same_clustering(o["labels"], out["sync"]["labels"]):
            raise RuntimeError(f"schedule check: the {sched} schedule's clustering differs "
                               f"from sync's where no contour is cut")
        del model
    return {"generator": "make_d2", "n": FULL_N, "lanes": LANES, **UNCUT,
            "merge_radius": ddc.DDCConfig(**UNCUT).merge_radius, "through": "DDC facade, jit",
            "same_clustering": True,
            **{k: {f: v for f, v in o.items() if f != "labels"} for k, o in out.items()}}


def facade_full_width(torch, np, ddc, ops, spatial, dev, eps, pts, sched_labels, ts,
                      card: str) -> dict:
    """The facade on the card at full width (see the module docstring,
    phase 2's last item).  Returns its line."""
    from repro_torch import ddc as T
    from repro_torch.serve import query_tier as qt

    base = dict(eps=eps, min_pts=4, backend="jit", shards=LANES)
    fits = {}
    for sched in ("sync", "async"):
        ops.reset_launch_counts()
        model, labels, wall = facade_model(torch, T, dict(base, schedule=sched), pts, dev)
        launches = ops.launch_counts()
        if not np.array_equal(labels, sched_labels[sched]) or labels.dtype != np.int32:
            raise RuntimeError(f"facade ({sched}): labels_ differ from the full-width path's "
                               f"global labels")
        if any(launches[k] < 1 for k in ("neighbor_count_sparse", "min_label_sweep_sparse",
                                         "contour_min_d2")):
            raise RuntimeError(f"facade ({sched}): the fit did not launch B3, B4 and B5: "
                               f"{launches}")
        tr = model.backend.last_trace
        fits[sched] = {"fit_s": wall, "phase1_s": tr["phase1_s"], "phase2_s": tr["phase2_s"],
                       "host_overhead_s": wall - tr["phase1_s"] - tr["phase2_s"],
                       "launches": {k: v for k, v in launches.items() if v},
                       "labels_equal_path": True}
        if sched == "sync":
            sync_model, sync_labels = model, labels
        else:
            del model
    fits["sync"]["path_phase1_s_plus_phase2_s"] = ts["phase1_s"] + ts["phase2_s"]
    model = sync_model

    # The query tier: one request of every probe, then the same probes as
    # FACADE_REQUESTS requests through submit / drain (coalesced).
    rng = np.random.default_rng(7)
    n_fit, n_near, n_out = FACADE_PROBES
    near = pts[rng.integers(0, FULL_N, n_near)] + rng.uniform(-eps, eps, (n_near, 2))
    outside = rng.uniform(1.05, 1.5, (n_out, 2)) * rng.choice([-1.0, 1.0], (n_out, 2))
    fit_idx = rng.choice(FULL_N, n_fit, replace=False)
    probes = np.concatenate([pts[fit_idx], near, outside]).astype(np.float32)
    t0 = time.perf_counter()
    res = model.query(probes)
    query_s = time.perf_counter() - t0
    labels_q = res.labels
    tier = model.query_tier
    before = tier.counters()

    def drain():
        for part in np.array_split(probes, FACADE_REQUESTS):
            tier.submit(part)
        return tier.drain()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drained = drain()
    drain_s = time.perf_counter() - t0
    after = tier.counters()
    tier_counts = {k: after[k] - before[k] for k in after}
    if not np.array_equal(np.concatenate([r.labels for r in drained]), labels_q):
        raise RuntimeError("facade: the coalesced drain's labels differ from one query's")
    routed = sum(1 for r in drained if r.scanned_shards)
    if tier_counts["coalesced_requests"] != routed or routed < 2:
        raise RuntimeError(f"facade: the drain did not coalesce its {routed} routed requests: "
                           f"{tier_counts}")
    snap = model.backend.snapshot()
    cpu_snap = dataclasses.replace(snap, pts=snap.pts.cpu(), mask=snap.mask.cpu(),
                                   glabels=snap.glabels.cpu())
    t0 = time.perf_counter()
    labels_cpu = qt.QueryTier(FrozenSource(cpu_snap), max_queries=model.config.max_queries,
                              bucket_min=model.config.query_bucket_min).query(probes).labels
    cpu_query_s = time.perf_counter() - t0
    if not np.array_equal(labels_q, labels_cpu):
        raise RuntimeError(f"facade: card query labels differ from the CPU's on "
                           f"{int((labels_q != labels_cpu).sum())} of {len(probes)} probes")
    own = sync_labels[fit_idx]
    if not np.array_equal(labels_q[:n_fit][own >= 0], own[own >= 0]) \
            or (labels_q[n_fit + n_near:] != -1).any():
        raise RuntimeError("facade: a fitted clustered probe did not get its own label, or "
                           "a probe outside the bounds hit a cluster")
    # One launch at the full width: every shard scanned, max_queries rows.
    sel = np.arange(LANES)
    g_pts, g_mask, g_lab = tier._gather(snap, sel)
    q_dev = torch.as_tensor(probes[:model.config.max_queries], device=dev)
    launch_ms = median_ms(torch, lambda: qt._snapshot_query(q_dev, g_pts, g_mask, g_lab,
                                                            snap.eps), 10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    qt._snapshot_query(q_dev, g_pts, g_mask, g_lab, snap.eps)
    torch.cuda.synchronize()
    launch_peak = torch.cuda.max_memory_allocated(dev) - mem0
    query = {"probes": len(probes), "fitted": n_fit, "near": n_near, "outside": n_out,
             "requests": FACADE_REQUESTS, "routed_requests": routed, "query_s": query_s,
             "query_probes_per_s": len(probes) / query_s, "drain_s": drain_s,
             "drain_probes_per_s": len(probes) / drain_s, **tier_counts,
             "launch_ms": launch_ms, "launch_rows": int(q_dev.shape[0]),
             "launch_slots": int(g_pts.shape[0] * g_pts.shape[1]),
             "launch_peak_bytes": launch_peak, "cpu_query_s": cpu_query_s,
             "card_equals_cpu": True, "hits": int((labels_q >= 0).sum())}

    # Where the time goes: one facade fit and one drain under the profiler.
    prof_fit = profile_fn(torch, lambda: T.DDC(T.DDCConfig(**base, schedule="sync"),
                                                device=dev).fit(pts).labels_,
                          fits["sync"]["fit_s"], top=8)
    prof_drain = profile_fn(torch, drain, drain_s, top=6)

    # Save and load at full width: no refit, the same labels and answers.
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        restored = T.DDC.load(path, device=dev)
        load_s = time.perf_counter() - t0
    if not np.array_equal(restored.labels_, model.labels_) \
            or not np.array_equal(restored.query(probes).labels, labels_q):
        raise RuntimeError("facade: the restored model's labels or answers differ")
    g0, g1 = model.stats().gauges, restored.stats().gauges
    if restored.backend.refits or (g1.n_live, g1.n_clusters, g1.shards, g1.capacity) != \
            (g0.n_live, g0.n_clusters, g0.shards, g0.capacity):
        raise RuntimeError(f"facade: the restored model refitted or its gauges differ: "
                           f"{g1} vs {g0}")
    snapshot = {"bytes": nbytes, "save_s": save_s, "load_s": load_s, "refits_after_load": 0,
                "labels_equal": True, "answers_equal": True, "gauges_equal": True}
    del restored, model, sync_model

    # The host backend on the card, against the jit backend, at the repo's
    # 2,048-point layouts.  dbscan_ref materialises n × n float64, so the
    # host backend cannot run at full width.
    host = {}
    for layout, spec in spatial.PHASE2_LAYOUTS.items():
        lpts = spec["make"](FACADE_HOST_N)
        kw = {k: spec[k] for k in ("eps", "min_pts", "grid", "max_verts", "max_clusters")}
        for k in (2, 4, 8):
            m_host, l_host, host_s = facade_model(torch, T, dict(kw, backend="host", shards=k),
                                                  lpts, dev)
            _, l_jit, jit_s = facade_model(torch, T, dict(kw, backend="jit", shards=k,
                                                          schedule="sync"), lpts, dev)
            answers = m_host.query(lpts).labels
            if not ddc.same_clustering(l_host, l_jit) \
                    or not np.array_equal(answers[l_host >= 0], l_host[l_host >= 0]):
                raise RuntimeError(f"facade host backend on {layout} k={k}: differs from the "
                                   f"jit backend, or its answers from its labels")
            host[f"{layout}/{k}"] = {"host_s": host_s, "jit_s": jit_s,
                                     "clusters": int(len(set(l_host[l_host >= 0].tolist())))}
    sample = pts[np.random.default_rng(3).choice(FULL_N, FACADE_SAMPLE, replace=False)]
    t0 = time.perf_counter()
    try:
        T.DDCConfig(**base).validate(sample=sample)
        verdict = "accepted"
    except T.ConfigError as e:
        verdict = str(e)
    validate = {"n": FACADE_SAMPLE, "s": time.perf_counter() - t0, "verdict": verdict}
    return {"card": card, "n": FULL_N, "lanes": LANES, "eps": eps, "fits": fits,
            "query": query, "profile_fit": prof_fit, "profile_drain": prof_drain,
            "snapshot": snapshot,
            "host_backend": {"n": FACADE_HOST_N, "same_clustering_as_jit": True,
                             "answers_equal_labels": True, "cells": host,
                             "full_width": "not run: dbscan_ref builds the n x n float64 "
                                           "distance matrix (core/dbscan.py:54)"},
            "validate_sample": validate}


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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_floor
    from repro_torch.kernels import pairwise_dist as pd_mod
    from repro_torch.kernels import ssd_scan as ssd

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

    # -- LM: the serving path at full width and depth ----------------------
    t_lm = time.perf_counter()
    lm_launches, captured, lm_routes = lm_phase(torch, dev, card.splitlines()[0])
    lm_kernels = lm_kernel_entries(torch, ops, ref, fa, ssd, captured, lm_launches,
                                   {"flash_attention": lm_routes["qwen3-8b"]["flash_attention"],
                                    "ssd_scan": lm_routes["mamba2-1.3b"]["ssd_scan"]})
    lm_kernels.append(moe_gather_entry(torch, ops, ref, captured, lm_launches))
    del captured
    print(json.dumps({"lm_kernel_sweep": lm_kernel_sweep(torch, ops, ref, fa, ssd, dev)}),
          flush=True)
    print(json.dumps({"moe_gather_sweep": moe_gather_sweep(torch, ops, ref, dev)}), flush=True)
    long_attn = long_prefill_attention(torch, ops, fa, dev)
    torch.cuda.empty_cache()
    print(json.dumps({"lm_long_prefill_attention": long_attn,
                      "lm_phase_s": time.perf_counter() - t_lm}), flush=True)

    # -- 2. full width: eps search on the default configuration ----------
    pts = spatial.make_d2(FULL_N, seed=1)
    mask = np.ones(FULL_N, bool)
    eps = 0.03 * math.sqrt(2048 / FULL_N)
    eps_tried = []
    for _ in range(10):
        cfg = ddc.DDCConfig(eps=eps, min_pts=4, schedule="sync")
        _, gcs, _ = ddc.make_ddc_fn(cfg, LANES, device=dev)(pts, mask)
        eps_tried.append(eps)
        log(f"eps={eps:.6f} overflow={bool(gcs.overflow)}")
        if not bool(gcs.overflow):
            break
        eps *= 1.25
    else:
        raise RuntimeError(f"cluster budget overflows at every eps tried: {eps_tried}")

    # The default path: block-sparse DBSCAN in every lane.  "auto" takes
    # it only where the ops launch kernels (as the reference's takes it
    # only with its kernels), so the plain run asks for it with "always".
    meter_s = ddc.CommMeter()
    out_s, ts, launches_s, trs = full_width_path(
        torch, ddc, dbscan, ops, cfg, dataclasses.replace(cfg, block_sparse="always"),
        pts, mask, "sparse", meter=meter_s)
    if [p["path"] for p in ts["paths"]] != ["sparse"] * LANES:
        raise RuntimeError(f"the default path did not run the sparse kernels in every "
                           f"lane: {ts['paths']}")
    for k in ("neighbor_count_sparse", "min_label_sweep_sparse", "contour_min_d2"):
        if launches_s[k] < 1:
            raise RuntimeError(f"a kernel of the sparse path never launched: {launches_s}")
    # The dense path.
    cfg_d = dataclasses.replace(cfg, block_sparse="never")
    out_d, td, launches_d, trd = full_width_path(torch, ddc, dbscan, ops, cfg_d, cfg_d, pts,
                                                 mask, "dense")
    for k in ("neighbor_count", "min_label_sweep", "contour_min_d2"):
        if launches_d[k] < 1:
            raise RuntimeError(f"a kernel of the dense path never launched: {launches_d}")
    diff = differences(torch, ddc, dbscan, out_s, out_d, ts, td,
                       ("labels", "core", "n_clusters"))
    if diff:
        raise RuntimeError(f"the sparse path differs from the dense path in {diff}")
    n_global = check_output(torch, cfg, out_s)
    c = cfg.max_clusters

    # The async and tree schedules on the default path, each driven as a
    # full-width path.  They give sync's clustering only under the
    # reference's vertex-budget rule (DESIGN.md §7: every local and merged
    # contour fits max_verts); at grid 128 the full-width lanes' outlines
    # fill any budget up to 4,096 and are cut, and a cut outline merges
    # differently in pairs than all at once, in the reference too.  So
    # agreement is reported on the default path and held by
    # ``schedule_check`` where no contour is cut and the data holds several
    # global clusters (``UNCUT``), through the facade.
    schedules = {"sync": {"phase1_s": ts["phase1_s"], "phase2_s": ts["phase2_s"],
                          "merge_calls": ts["merge_calls"], "meter": meter_s.snapshot()}}
    sched_labels = {"sync": out_s[0].cpu().numpy()}
    for sched in ("async", "tree"):
        scfg = dataclasses.replace(cfg, schedule=sched)
        meter = ddc.CommMeter()
        out_x, tx, launches_x, trx = full_width_path(
            torch, ddc, dbscan, ops, scfg, dataclasses.replace(scfg, block_sparse="always"),
            pts, mask, sched, meter=meter)
        for k in ("neighbor_count_sparse", "min_label_sweep_sparse", "contour_min_d2"):
            if launches_x[k] < 1:
                raise RuntimeError(f"a kernel of the {sched} path never launched: {launches_x}")
        schedules[sched] = {
            "phase1_s": tx["phase1_s"], "phase2_s": tx["phase2_s"],
            "plain_phase2_s": trx["phase2_s"], "merge_calls": tx["merge_calls"],
            "meter": meter.snapshot(), "n_clusters": check_output(torch, scfg, out_x),
            "launches": launches_x, "bit_identical_to_plain": True,
            "same_clustering_as_sync": ddc.same_clustering(out_x[0].cpu().numpy(),
                                                           out_s[0].cpu().numpy())}
        sched_labels[sched] = out_x[0].cpu().numpy()
    uncut = schedule_check(torch, np, ddc, pts, dev)
    print(json.dumps({"schedules_full_width": {**schedules, "uncut": uncut}}), flush=True)

    # K-Means (this slice's path): the defaults (k 8, 25 Lloyd steps, async
    # merge) at the eps found above, which sets only the merge radius.
    cfg_km = dataclasses.replace(cfg, local_algo="kmeans", schedule="async")
    out_km, tkm, launches_km, trkm = full_width_path(
        torch, ddc, dbscan, ops, cfg_km, cfg_km, pts, mask, "kmeans",
        fields=("labels", "centroids", "inertia"))
    want_launches = (25 + 1) * LANES
    if launches_km["pairwise_dist_sq"] != want_launches or launches_km["contour_min_d2"] < 1:
        raise RuntimeError(f"the K-Means path launched {launches_km}, expected "
                           f"{want_launches} pairwise_dist_sq")
    n_global_km = check_output(torch, cfg_km, out_km)
    print(json.dumps({"kmeans_full_width": {
        "n": FULL_N, "lanes": LANES, "kmeans_k": cfg_km.kmeans_k, "iters": 25,
        "schedule": cfg_km.schedule, "merge_radius": cfg_km.merge_radius,
        "phase1_s": tkm["phase1_s"], "phase2_s": tkm["phase2_s"],
        "plain_phase1_s": trkm["phase1_s"], "plain_phase2_s": trkm["phase2_s"],
        "launches": launches_km, "merge_calls": tkm["merge_calls"],
        "lane_inertia": [float(r.inertia) for r in tkm["results"]],
        "n_clusters": n_global_km, "bit_identical_to_plain": True,
        "two_runs_identical": True}}), flush=True)

    # The delta merge at full width (A4: the stream engine's phase 2 on the
    # rectangular form of B5).
    delta_line, batch3, launches_delta = delta_full_width(
        torch, ddc, ops, cfg, ts["batch"], spatial.make_d2(FULL_N, seed=DELTA_SEED), mask)
    print(json.dumps({"delta_full_width": delta_line}), flush=True)

    # Each kernel against its plain version on the main path's inputs
    # (lane 0 for phase 1, the stacked batch for phase 2).
    per = FULL_N // LANES
    bt = cfg.block_tile
    x0 = torch.as_tensor(pts[:per], device=dev)
    m0 = torch.ones(per, dtype=torch.bool, device=dev)
    xc = dbscan.center_points(x0, m0).contiguous()
    res0 = td["results"][0]
    lab_in = torch.where(res0.core, res0.labels, dbscan.SENTINEL).to(torch.int32)
    sp, sm, order = dbscan.spatial_sort(xc, m0, bt)
    sp, sm = sp.contiguous(), sm.contiguous()
    pairs = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    npad = sp.shape[0]
    core_s = ts["results"][0].core[order].contiguous()
    lab_s = torch.where(core_s, torch.arange(npad, dtype=torch.int32, device=dev),
                        dbscan.SENTINEL).to(torch.int32)
    n_act = int(pairs.n_active)
    per_tile = sm.reshape(-1, bt).sum(dim=1, dtype=torch.int64)
    # The counts and the sweeps test each unordered pair once (d2 is
    # symmetric bit for bit, and one test gives both rows their increment
    # or their min), so their bounds count unordered pairs: the dense
    # kernels' n(n+1)/2, the sparse ones' within each diagonal tile and
    # across each active pair I < J of the upper list.
    n_up = int(pairs.n_up)
    sym_sparse_tests = int((per_tile * (per_tile + 1) // 2).sum()
                           + (per_tile[pairs.up_rows[:n_up].long()]
                              * per_tile[pairs.up_cols[:n_up].long()]).sum())
    t_tiles = npad // bt
    pair_bytes = (t_tiles + 1) * 4 + n_act * 4
    batch = ts["batch"]
    mslots = LANES * c
    v = cfg.max_verts
    conts = batch.contours.reshape(mslots, v, 2).contiguous()
    cnts = batch.counts.reshape(mslots).contiguous()
    valids = batch.valid.reshape(mslots).contiguous()
    n_valid = int(m0.sum())
    sym_dense_tests = n_valid * (n_valid + 1) // 2
    cents0 = tkm["results"][0].centroids.contiguous()
    k_cents = cents0.shape[0]
    # B5's square entry counts the vertex pairs of each unordered pair of
    # distinct valid slots once (one test serves (i, j) and (j, i)); the
    # rectangular one, the delta merge's 96 dirty rows (three lanes) against
    # every slot, each row-column pair.  Their bytes: every slot's count and
    # flag, the valid slots' real vertices (no function needs the padding
    # or an empty slot's contour) and the dense output, each once.
    sq_extra = contour_extra(torch, "contour_min_d2", cnts, valids, v,
                             lambda: ops.contour_min_d2(conts, cnts, valids))
    rows_idx = torch.cat([torch.arange(i * c, (i + 1) * c, device=dev) for i in DELTA_DIRTY])
    b_conts = batch3.contours.reshape(mslots, v, 2).contiguous()
    b_cnts = batch3.counts.reshape(mslots).contiguous()
    b_valids = batch3.valid.reshape(mslots).contiguous()
    r_conts, r_cnts, r_valids = (t[rows_idx].contiguous() for t in (b_conts, b_cnts, b_valids))
    r_tot = int(slot_counts(torch, r_cnts, r_valids, v).sum())
    b_tot = int(slot_counts(torch, b_cnts, b_valids, v).sum())
    nrows = rows_idx.numel()
    if not same(torch, ops.cross_min_d2(r_conts, r_cnts, r_valids, b_conts, b_cnts, b_valids),
                ops.contour_min_d2(b_conts, b_cnts, b_valids)[rows_idx]):
        raise RuntimeError("cross_min_d2: the rectangular rows differ from the square matrix's")
    sym_src, pd = "pair_sweep.cu", "src/repro/kernels/pairwise_dist.py"
    cases = [
        ("neighbor_count", sym_src, f"{pd}:91", [per],
         lambda: ops.neighbor_count(xc, m0, eps), lambda: ref.neighbor_count(xc, m0, eps),
         bound(sym_dense_tests * NC_OPS_PER_PAIR, per * (8 + 1 + 4)), launches_d, "dense"),
        ("min_label_sweep", sym_src, f"{pd}:147", [per],
         lambda: ops.min_label_sweep(xc, m0, lab_in, res0.core, eps),
         lambda: ref.min_label_sweep(xc, m0, lab_in, res0.core, eps),
         bound(sym_dense_tests * NC_OPS_PER_PAIR, per * (8 + 1 + 4 + 1 + 4)), launches_d,
         "dense"),
        ("neighbor_count_sparse", sym_src, f"{pd}:222", [npad, bt, n_act],
         lambda: ops.neighbor_count_sparse(sp, sm, eps, pairs, bt=bt),
         lambda: ref.neighbor_count_sparse(sp, sm, eps, pairs.rows, pairs.cols, pairs.flags,
                                           bt),
         bound(sym_sparse_tests * NC_OPS_PER_PAIR, npad * (8 + 1 + 4) + pair_bytes),
         launches_s, "sparse"),
        ("min_label_sweep_sparse", sym_src, f"{pd}:289", [npad, bt, n_act],
         lambda: ops.min_label_sweep_sparse(sp, sm, lab_s, core_s, eps, pairs, bt=bt),
         lambda: ref.min_label_sweep_sparse(sp, sm, lab_s, core_s, eps, pairs.rows,
                                            pairs.cols, pairs.flags, bt),
         bound(sym_sparse_tests * NC_OPS_PER_PAIR, npad * (8 + 1 + 4 + 1 + 4) + pair_bytes),
         launches_s, "sparse"),
        ("contour_min_d2", "contour_dist.cu", "src/repro/kernels/contour_dist.py:52",
         [mslots, v], lambda: ops.contour_min_d2(conts, cnts, valids),
         lambda: ref.contour_min_d2(conts, cnts, valids),
         bound(sq_extra["bound_tests"] * CMD2_OPS_PER_PAIR,
               sq_extra["valid_vertices"] * 8 + mslots * (4 + 1) + mslots * mslots * 4),
         launches_s, "sparse"),
        ("cross_min_d2", "contour_dist.cu", "src/repro/kernels/contour_dist.py:52",
         [nrows, mslots, v],
         lambda: ops.cross_min_d2(r_conts, r_cnts, r_valids, b_conts, b_cnts, b_valids),
         lambda: ref.cross_min_d2(r_conts, r_cnts, r_valids, b_conts, b_cnts, b_valids),
         bound(r_tot * b_tot * CMD2_OPS_PER_PAIR,
               (r_tot + b_tot) * 8 + (nrows + mslots) * (4 + 1) + nrows * mslots * 4),
         launches_delta, "delta"),
        ("pairwise_dist_sq", "pairwise_dist.cu", f"{pd}:48", [per, cfg_km.kmeans_k],
         lambda: ops.pairwise_dist_sq(x0, cents0), lambda: ref.pairwise_dist_sq(x0, cents0),
         bound(per * k_cents * PD_OPS_PER_PAIR, per * 8 + k_cents * 8 + per * k_cents * 4),
         launches_km, "kmeans"),
    ]
    libraries = {"pairwise_dist_sq": lambda: torch.cdist(
        x0, cents0, compute_mode="use_mm_for_euclid_dist")}
    sweeps = {
        "neighbor_count": sweep_extra(
            torch, "neighbor_count", pd_mod.sym_work_items(per), pd_mod.SYM_DENSE_TILE,
            sym_dense_tests, lambda: ops.neighbor_count(xc, m0, eps)),
        "neighbor_count_sparse": sweep_extra(
            torch, "neighbor_count_sparse", pd_mod.sym_work_items(npad, pairs, bt=bt),
            pd_mod.sym_tile(bt), sym_sparse_tests,
            lambda: ops.neighbor_count_sparse(sp, sm, eps, pairs, bt=bt)),
        "min_label_sweep": sweep_extra(
            torch, "min_label_sweep", pd_mod.sym_work_items(per), pd_mod.SYM_DENSE_TILE,
            sym_dense_tests, lambda: ops.min_label_sweep(xc, m0, lab_in, res0.core, eps)),
        "min_label_sweep_sparse": sweep_extra(
            torch, "min_label_sweep_sparse", pd_mod.sym_work_items(npad, pairs, bt=bt),
            pd_mod.sym_tile(bt), sym_sparse_tests,
            lambda: ops.min_label_sweep_sparse(sp, sm, lab_s, core_s, eps, pairs, bt=bt)),
        "contour_min_d2": sq_extra,
        "cross_min_d2": {
            **two_launches(torch, "cross_min_d2", lambda: ops.cross_min_d2(
                r_conts, r_cnts, r_valids, b_conts, b_cnts, b_valids)),
            "dirty_lanes": list(DELTA_DIRTY), "bound_tests": r_tot * b_tot,
            "valid_vertices": [r_tot, b_tot],
            "replaces_also": "src/repro/core/ddc.py:226 (cross_min_d2)",
            "rows_equal_square_rows": True},
        "pairwise_dist_sq": two_launches(torch, "pairwise_dist_sq",
                                         lambda: ops.pairwise_dist_sq(x0, cents0))}
    kernels = [kernel_entry(torch, name, src, replaces, shape, kern, plain, b_ms, b_by,
                            launches[name], path, libraries.get(name),
                            extra=sweeps.get(name))
               for name, src, replaces, shape, kern, plain, (b_ms, b_by), launches, path
               in cases]
    # The launch floor: an empty kernel, timed as every kernel above.
    floor_ms = median_ms(torch, lambda: launch_floor.empty(dev), 20, per=10)
    print(json.dumps({"launch_floor": {"ms": floor_ms, "source":
                                       "src/repro_torch/kernels/csrc/launch_floor.cu",
                                       "timing": "10 calls queued behind a spin kernel, "
                                                 "median of 20 batches"}}), flush=True)
    for entry in kernels + lm_kernels:
        entry["floor_ms"] = floor_ms
    print(json.dumps({"kernels": kernels + lm_kernels}), flush=True)
    # One more default-path run, dense run and K-Means run under the
    # profiler, against the unprofiled runs' wall time.
    run = ddc.make_ddc_fn(cfg, LANES, device=dev)
    print(json.dumps({"profile": profile_fn(torch, lambda: run(pts, mask),
                                            ts["phase1_s"] + ts["phase2_s"], top=10,
                                            require=("neighbor_count_sparse_sym_kernel",
                                                     "min_label_sparse_sym_kernel"))}),
          flush=True)
    run_d = ddc.make_ddc_fn(cfg_d, LANES, device=dev)
    print(json.dumps({"profile_dense": profile_fn(torch, lambda: run_d(pts, mask),
                                                  td["phase1_s"] + td["phase2_s"], top=10,
                                                  require=("neighbor_count_sym_kernel",
                                                           "min_label_sym_kernel"))}),
          flush=True)
    run_km = ddc.make_ddc_fn(cfg_km, LANES, device=dev)
    print(json.dumps({"profile_kmeans": profile_fn(torch, lambda: run_km(pts, mask),
                                                   tkm["phase1_s"] + tkm["phase2_s"], top=10)}),
          flush=True)

    # The facade at full width: DDC(DDCConfig(...)).fit through the jit
    # backend, its query tier, save / load, the host backend.
    print(json.dumps({"facade_full_width": facade_full_width(
        torch, np, ddc, ops, spatial, dev, eps, pts, sched_labels, ts,
        card.splitlines()[0])}), flush=True)
    torch.cuda.empty_cache()

    # -- 3. BENCH_phase1.json's scenarios ----------------------------------
    bench_rows = phase1_bench(torch, np, dbscan, ops, spatial, dev)
    print(json.dumps({"phase1_bench": bench_rows}), flush=True)

    # -- 4. oracle parity at the tuned 2048-point sizes --------------------
    clusters: dict[str, list[int]] = {}
    auto_paths: dict[str, int] = {}
    parity_cells = 0
    for name, (make, p_eps, min_pts, grid, max_verts, max_clusters) in \
            spatial.PARITY_CASES.items():
        lpts = make()
        host = {k: ddc.ddc_host(lpts, k, p_eps, min_pts, contour="grid")[0]
                for k in PARITY_SHARDS}
        for schedule, block_sparse in PARITY_RUNS:
            for k in PARITY_SHARDS:
                pcfg = ddc.DDCConfig(eps=p_eps, min_pts=min_pts, grid=grid,
                                     max_verts=max_verts, max_clusters=max_clusters,
                                     schedule=schedule, block_sparse=block_sparse)
                ptrace: dict = {}
                gl, pgcs, _ = ddc.make_ddc_fn(pcfg, k, device=dev)(
                    lpts, np.ones(len(lpts), bool), ptrace)
                if bool(pgcs.overflow) or not ddc.same_clustering(gl.cpu().numpy(), host[k]):
                    raise RuntimeError(f"parity {name} k={k} {schedule} {block_sparse}: port "
                                       f"differs from ddc_host (overflow "
                                       f"{bool(pgcs.overflow)})")
                parity_cells += 1
                if block_sparse == "auto":
                    for p in ptrace["paths"]:
                        auto_paths[p["path"]] = auto_paths.get(p["path"], 0) + 1
                elif schedule == "sync":
                    clusters.setdefault(name, []).append(
                        len(set(host[k][host[k] >= 0].tolist())))
    print(json.dumps({"parity": {"shards": list(PARITY_SHARDS),
                                 "runs": [list(r) for r in PARITY_RUNS],
                                 "cells": parity_cells,
                                 "all_same_clustering": True, "clusters": clusters,
                                 "auto_lane_paths": auto_paths}}), flush=True)

    # -- 5. BENCH_phase2.json's rows ---------------------------------------
    bench2 = phase2_bench(np, ddc, spatial, dev)
    print(json.dumps({"phase2_bench": bench2}), flush=True)

    # -- 6. the full-width numbers, then the contract line -----------------
    def path_numbers(trace, plain, launches):
        return {"phase1_s": trace["phase1_s"], "phase2_s": trace["phase2_s"],
                "plain_phase1_s": plain["phase1_s"], "plain_phase2_s": plain["phase2_s"],
                "sweeps_per_lane": [int(r.n_sweeps) for r in trace["results"]],
                "lane_paths": [p["path"] for p in trace["paths"]],
                "lane_n_active": [p["n_active"] for p in trace["paths"]],
                "lane_frac": [p["frac"] for p in trace["paths"]],
                "launches": launches, "bit_identical_to_plain": True}

    print(json.dumps({"full_width": {
        "n": FULL_N, "lanes": LANES, "eps": eps, "eps_tried": eps_tried,
        "min_pts": cfg.min_pts, "grid": cfg.grid, "max_clusters": c,
        "max_verts": v, "block_tile": bt,
        "lane_clusters": [int(r.n_clusters) for r in ts["results"]],
        "n_clusters": n_global, "sparse_equals_dense": True,
        "sparse": path_numbers(ts, trs, launches_s),
        "dense": path_numbers(td, trd, launches_d)}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
