#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them:
DDC's pipeline and the LM stack's serving and training paths.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels under
``src/repro_torch/kernels/csrc`` are built at first use).  Imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (non-zero exit):

1. The card (``nvidia-smi`` name and power limit) and the kernel build.
LM. The serving path at full width (``LM_ARCHS``): qwen3-8b (36 layers,
   d_model 4096, GQA 32/8), mamba2-1.3b (48 layers, d_model 2048, the SSD
   scan), minicpm3-4b (62 layers, MLA: q/kv low-rank 768/256, qk dim 96 =
   nope 64 + rope 32, v 64 padded to 96) and whisper-small (12 encoder + 12
   decoder layers, d_model 768, seeded frames of 4 x 1,500 x 768) at full
   depth; llama4-scout (d_model 5120, 16 experts top-1 + shared) cut to 4 of
   48 layers, internvl2-26b (d_model 6144, GQA 48/8, a seeded 4 x 256 x
   6,144 prefix) to 24 of 48, kimi-k2 (d_model 7168, 384 experts of 2,048
   top-8 + shared, vocab 163,840) to 1 of 61 and jamba-1.5-large (d_model
   8192, 7 Mamba-2 + MLP layers and one attention + 16-expert MoE layer) to
   one 8-layer group of 72 (``LM_LAYERS``, with the memory reckoning).  bf16
   weights from a seeded ``torch.Generator`` with the reference's scales, 4
   requests of 2,048 prompt tokens each (seeded), ``greedy_generate`` for 16
   tokens (max_len 2,064 plus the prefix).  Per model: the launches equal
   ``lm_launch_plan`` (attention once per attention layer in prefill,
   whisper's 12 encoder layers and 12 cross-attentions in prefill and 12
   more in each decode step; SSD once per Mamba layer in prefill; the MoE
   gather once per MoE layer in prefill and in each decode step; counts
   zeroed just before the run and read just after), and in bf16 every
   attention launch takes the route of the head dim it gets (the tensor
   cores, ``flash_attention_tc.cu``, at 64, 128 and MLA's 96; the CUDA
   cores, ``flash_attention.cu``, at any other) and every SSD launch the
   tensor cores (``ssd_scan_tc.cu``), the float32 runs below the CUDA-core
   ones, by the route counts; a second kernel run gives bit-identical
   tokens and logits; the same path under ``ops.FORCE = "ref"`` (the plain
   versions, routed as the reference routes off the TPU), teacher-forced on
   the kernel run's tokens, is held to the kernel run on the prefill's
   last-token logits and on every decode step's logits, in bf16 and with the
   weights cast to float32 in place after the bf16 runs (``cast_in_place``;
   tolerances at ``LM_F32_TOL`` and ``LM_BF16_NOISE``); in bf16 the plain
   run routes every MoE token by the kernel run's decisions (replayed from
   its route log, the gates from its own probabilities), so that a routing
   flip between two bf16 runs is not what the gate measures; how many
   greedy tokens the plain run would pick alike is reported, not gated.
   For the MoE models the token-copies dropped at capacity are printed per
   layer, and the routing decisions that differ between the kernel and
   plain runs in float32, where there must be none, and in bf16 without the
   replay (reported; with it they are 0 by construction, and checked).
   Prefill time, decode time per token, tokens/s and peak memory are
   printed beside the card.  Each LM kernel is held against its plain
   version on the inputs the main path gave its first layer (qwen3-8b,
   mamba2-1.3b, llama4-scout), in bf16 and cast up to float32, and at the
   other models' shapes (``at_model_shapes``: MLA's d 96, whisper's encoder,
   cross-attention in prefill (2,048 queries against 1,500 keys) and in
   decode (one query), internvl2's 2,304 positions, jamba's SSD, kimi-k2's
   and jamba's gathers in prefill and decode; attention there also on the
   CUDA-core kernel, timed beside the tensor cores and SDPA), and on
   ``FLASH_SWEEP`` and ``SSD_SWEEP`` (tests/test_kernels.py's shapes,
   ragged lengths, windows, bf16, MLA's padded v, each case on the route
   its dtype and shape pick), at
   ``LM_KERNEL_F32_TOL`` and ``bf16_tol``, the CUDA-core kernels also timed
   and held on the bf16 first-layer inputs; the MoE gather bit for bit in
   both modes, there and on ``MOE_GATHER_SWEEP``; flash_attention is also
   timed at prefill_32k's length (one sequence, one layer's q/k/v) beside
   the CUDA-core kernel and ``scaled_dot_product_attention``, not gated.
   Then ``python -m repro_torch.launch.serve --mode lm`` (``lm_cli`` line):
   every architecture's tiny configuration in this process, its launches
   equal to its plan, and whisper-small at full width as its own process.
LM training (``lm_train`` lines, ``TRAIN_ARCHS``): qwen3-8b (8 of 36
   layers, AdamW), mamba2-1.3b (24 of 48 layers, AdamW) and llama4-scout (1 of 48
   layers, Adafactor) at full width, float32 parameters, batches of 2 ×
   2,048 tokens from ``data/pipeline.py`` at seed 0, the reference's
   optimizer defaults.  Each trains 3 steps from the seed through
   ``train/step.py::build_train_step`` with the kernels (B7, B8 and B9
   forward inside ``torch.autograd.Function``s whose backward is the plain
   version's VJP; launches equal to one forward's plan a step, all on the
   CUDA cores in float32) and 3 with ``ops.FORCE = "ref"`` (remat "full",
   which changes no value): each step's loss within ``LM_F32_TOL``, gnorm
   within ``TRAIN_GNORM_RTOL``, every parameter tensor after the last step
   within ``TRAIN_PARAM_RTOL`` relative in norm.  One step with bf16
   parameters runs the tensor-core routes inside training: at the seed's
   parameters the RMS distance of every token's NLL and of every gradient
   entry from the float32 plain run's must be at most ``LM_BF16_NOISE`` ×
   the plain bf16 run's (the mean loss's distance, an average of ± token
   errors, is reported: on an H100 80GB HBM3 at 700 W it was 5.6e-4 against
   the plain run's 1.4e-4 for qwen3-8b while the gradient RMS agreed within
   0.1 %).  One
   more step is profiled (the card's activity only): device ms of the
   forward kernels and of the GEMMs, the busy share, and the span of the
   plain recompute by CUDA events.  The checkpoint check
   (``lm_train_checkpoint`` line): mamba2-1.3b at full width cut to
   ``TRAIN_CKPT_LAYERS``, trained under deterministic algorithms and saved
   after step 2 by a ``CheckpointManager``; restored into a fresh state,
   step 3 must equal the uninterrupted step 3 bit for bit (within
   ``TRAIN_CKPT_RTOL`` if an op refuses deterministic mode, named in the
   line).  Then
   ``python -m repro_torch.launch.train --arch qwen3-8b --tiny`` in this
   process (10 steps with checkpoints, ``--resume`` to 20, equal to an
   uninterrupted run) and ``examples/train_lm_torch.py --steps 20``
   (``lm_train_cli`` line).  The kernels line's B7, B8 and B9
   entries carry the training launches a step (``train_launches_per_step``).
   Then the LM stack over a mesh of ranks (``lm_mesh`` line; the block
   above ``lm_mesh_phase`` holds the cuts and tolerances): 4 rank
   processes share the card over gloo (collectives staged through pinned
   host memory); rank 0 first computes each one-rank reference from the
   same seeded draw, the ranks then hold their shards against it (a gloo
   scatter of rank 0's host copy).  qwen3-8b at full width (2 of 36
   layers) on (data 2, model 2) with FSDP: an AdamW step, then one with
   ``compress_grads``, losses, gnorms and each leaf's update; the first
   block group's leaves saved from (2, 2) and restored onto (4, 1) bit for
   bit.
   llama4-scout at full width (1 of 48) on (2, 2), at its published
   capacity factor 1.25: the final hidden states, aux and loss at 4 ×
   2,048 tokens under epsum, a2a and a2a with the int8 wire, the a2a
   branch with the tokens replicated at batch 1, each against the
   one-rank route with that mesh route's drops, and one Adafactor step
   under a2a without and one with the int8 wire (FSDP, 2 × 1,024
   tokens); each rank launches B7 and B9 (and B9's int8 mode on the send
   path, counted by ``moe_gather.mode_launches``).  Then
   ``launch/serve.py``'s ``serve_lm`` over 2 ranks (qwen3-8b cut to 2
   layers) against the one-card tokens,
   one train step on NCCL at world size 1 (a (1, 1) mesh; the machine has
   one card), and B9's int8 mode at the a2a send shape held bit for bit
   to its plain version and timed (the kernels line's
   ``dispatch_gather_int8`` entry).
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
   fit and one drain.  Then the stream engine (``stream_full_width``
   line): ``DDC(DDCConfig(eps, min_pts=4, backend="stream", shards=8,
   max_batch=256)).fit`` streams the set into 8 rings of 32,768 (B3, B4,
   B5 square), then ``STREAM_ROUNDS`` rounds each ingest 4,096 points of
   ``make_d2`` at ``DELTA_SEED`` into shard r mod 8 through
   ``partial_fit`` (stamped with a fix clock; the full ring evicts its
   oldest), refresh (one local phase, one rectangular B5 patch: checked
   every round) and answer 256 probes through the engine's sync query;
   every 8th round expires everything older than the clock minus
   ``STREAM_WINDOW`` and refreshes the 8 dirty shards; a forced full
   re-merge ends the path (launch counts zeroed before each part and
   read after; B3, B4 and both B5 forms must have launched; the metered
   bytes must be B + K·C·4 a round and K·B + K·C·4 for the full
   re-merge).  Six checks: (a) the patched matrix equals B5's square
   rebuild of the final batch and the full re-merge keeps labels and
   matrix; (b) the labels equal the batch path (``local_phase`` on each
   final ring, ``merge_many``); (c) the query tier's drain equals the sync
   query; (d) ``state_dict`` → ``from_state`` on the card, then one more
   round on both, equal; (e) shard 3's delta dropped beyond
   ``max_retries`` quarantines it, a query near it routes around it
   (degraded), and ``recover`` plus a refresh equal the restored twin of
   (d); (f) a reduced run (``STREAM_SMALL``) equal on the card and on the
   CPU in labels, matrix, answers, meter and ``state_dict``.  Printed:
   fit s, ingest / refresh / query ms (p50, p99), the full re-merge's ms,
   bytes, probes/s (sync and tier), launches a round, one refresh's
   profile and busy share, peak memory.
   Then the dist engine (``dist_full_width`` line): ``DDC(DDCConfig(eps,
   min_pts=4, backend="dist", shards=8, max_batch=256))``, 8 lanes on 8
   CUDA streams, and a ``backend="stream"`` twin take the stream phase's
   calls in the same call (the fit, ``STREAM_ROUNDS`` rounds with the sync
   query, the TTL expiries that dirty all 8 shards, the forced full
   re-merge; dist's launch counts zeroed before each part and read after,
   B3, B4 and both B5 forms must have launched, one phase 1 and one
   rectangular B5 a round).  After every refresh dist's labels, slot maps,
   dense labels and pair-d2 must equal stream's bit for bit, and every
   round's sync answers; the bytes metered from the fetched rows must be
   exactly B + K·C·4 a round and K·B + K·C·4 for the full re-merge.  Then:
   one more 8-dirty refresh under the profiler (kernels by stream from the
   Chrome trace: how many overlapped one on another stream, the busy
   share); ``state_dict`` → ``from_state`` from dist to stream and from
   stream to dist, then one more round on all four engines, equal; shard
   3's delta dropped beyond ``max_retries`` on both engines, quarantine,
   routed query and recovery equal; the tree of degree 4 at 16 lanes
   (``DIST_TREE_SHARDS`` Morton-sorted blocks on ``UNCUT``) equal to flat
   dist after every refresh; the reduced run (``STREAM_SMALL``) through
   dist, card == CPU; ``BENCH_serve.json``'s 32 rows (16 stream, 16 dist;
   ``benchmarks/serve.py``'s sequence) equal to the file in their
   hardware-free fields, with ``dist_axis_bytes_le_stream_delta``; and
   ``python -m repro_torch.launch.serve --mode ddc --backend dist --shards
   8`` and ``--mode track --backend dist`` on the card, each line's
   hardware-free fields equal to the ``--backend stream`` run's.  Printed
   beside the card: ingest, one-shard refresh, 8-dirty refresh and query
   ms (p50, p99) for both engines, B3 / B4 / B5 launches a round, the
   profile, peak memory.  The kernels line's B3, B4 and B5 entries carry
   the dist path's launches (``dist_launches``).
   Then the tree of aggregators (``hierarchy_full_width`` line): the same
   262,144 points of ``make_d2``, Morton-sorted, in 64 rings of 4,096 on
   ``UNCUT`` (32 clusters), fed alike to three ``ClusterService``s — the
   flat aggregator and trees of degree 4 (depth 3, 21 nodes) and 2 (depth
   6, 63 nodes); after the fit, 16 rounds of 1,024 points into shard
   r·4 mod 64 (from that shard's block of a Morton-sorted ``make_d2`` at
   ``DELTA_SEED``), every 4th round a TTL expiry of the next 64 fit stamps
   of every shard.  After every refresh both trees' labels, maps, ``valid``
   and ``sizes`` must equal the flat engine's bit for bit, and no local
   contour, node summary or global contour may fill ``max_verts`` (where
   the tree's equivalence is not promised; the largest is printed); the
   data must hold at least 3 global clusters; at the end every node cache
   equals its rebuild.  Then ``BENCH_hierarchy.json``'s 10 rows (16–256
   shards × degree 2 and 4, ``benchmarks/hierarchy.py``'s refresh
   sequence) on the card, their hardware-free fields equal to the file.
   Printed per topology: refresh ms p50 / p99, folds, absorbed folds and
   the busiest node's bytes a round, metered bytes a refresh, B3 / B4 /
   B5 (rectangular, square) launches in the fit, the rounds and the
   expiries, and one more round's refresh under the profiler.  Then
   cluster tracking (``tracking_full_width`` line): 8 blobs drifting in
   separate lanes (``make_drifting_blobs``, 32,768 points a frame, 24
   frames) played through ``DDC(DDCConfig(backend="stream", shards=8,
   track=True, ...))`` with ``tracking.play`` (window 7: rings of 32,768,
   229,376 points live at each refresh), flat and with the tree of degree
   2; the two tracker states must be bit-identical, as must a save at
   frame 12, ``DDC.load`` on the card and the resumed run, and the first 12
   frames under ``ops.FORCE = "ref"`` against the kernel run saved there;
   8 births and no other event, ID
   stability 1.0, and every track's velocity within 5e-3 of the true one.
   Printed: refresh ms p50, tracker update ms (mean, last), B5
   rectangular launches a generation, ``_global_d2``'s time at 256 × 256
   slots.  B5's rectangular entry in the kernels line adds its time at the
   tracker's shape and at a node fold's shape (a leaf's first child's 32
   rows against the leaf's D·32 slots), each beside the launch floor.
   Then DDC across processes (``ranks_full_width`` line): 8 rank
   processes (``launch/ranks.py``: ``spawn``, one gloo group on a
   ``file://`` store, ``src`` on their path, every rank on this card) run
   ``ddc_shard`` on the full-width set in 8 shards of 32,768 at the
   searched eps, under sync, async and tree and with K-Means ranks fed
   their initial centres (each run once as a warm-up, once counted, once
   under each rank's profiler); each must equal the one-process
   ``make_ddc_fn`` run of the same config in this call bit for bit
   (global labels, maps, every rank's global ClusterSet), the meter must
   equal the one-process meter and the ranks' gloo bytes must sum to it,
   every rank must launch B3 and B4 in every DBSCAN run and B5 once a
   fold (so every rank in sync and async).  Printed: the spawn and CUDA
   start-up apart, phase 1 (first start to last end) and phase 2 (wire
   included) beside the one-process times, each rank's device time and
   the busy share; the kernels line's B3, B4, B5 and B6 entries carry the
   ranks' launches (``ranks_launches``).  Then curation (``curation``
   line): the example's corpus (examples/data_curation_torch.py) on 8
   lanes equal to the same call on the CPU and the host path's
   clustering, and ``curate`` at 262,144 documents on 8 lanes equal to
   the same run under ``ops.FORCE = "ref"`` (halved until no cluster
   budget overflows).  Then the dry run (``dryrun_ddc`` line):
   ``repro_torch.launch.dryrun_ddc`` at 65,536 points, 256 and 512 lanes ×
   sync, tree and async, each meter equal to its closed form, the
   512-lane sync / async wire ratio 511/9, launches, peak memory and
   phase times; B5 at the 512-lane sync fold (32,768 slots, whose lists
   take the staged entry: a compaction launch, counted apart, then the
   main kernel; in that cell only) held to its plain version and timed,
   also in the kernels line (``at_512_lane_fold``).
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
import io
import json
import math
import os
import runpy
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
# The stream engine at full width (stream_full_width): rounds of traffic
# after the fit, each STREAM_ROUND_N new points of make_d2 at DELTA_SEED
# into shard r mod 8 in chunks of STREAM_CHUNK (a full ring evicts as
# many), a sync query of STREAM_PROBES probes; every STREAM_TTL_EVERY-th
# round a TTL expiry of everything stamped older than the clock minus
# STREAM_WINDOW.  The reduced card-vs-CPU run: STREAM_SMALL = (shards,
# capacity, rounds, points a round), at STREAM_SMALL_EPS times the
# full-width eps, block-sparse on both devices in tiles of
# STREAM_SMALL_TILE (the CPU's plain dense DBSCAN would take 5–10 s a
# local phase at 4,096 points; its plain sparse path about 1 s).
# Each shard takes one round, which evicts as many points as it brings; at
# (4, 4,096, 8, 1,024) the CPU's half took about 58 s in each of the stream
# and dist phases.
STREAM_ROUNDS = 32
STREAM_ROUND_N = 4096
STREAM_CHUNK = 256
STREAM_PROBES = 256
STREAM_TTL_EVERY = 8
STREAM_WINDOW = FULL_N - 8192
STREAM_FAULT_SHARD = 3
STREAM_SMALL = (4, 2048, 4, 512)
STREAM_SMALL_EPS = 2.0
STREAM_SMALL_TILE = 128
# The dist engine at full width (dist_full_width) takes stream_full_width's
# calls beside a stream twin; its tree check runs DIST_TREE_SHARDS lanes of
# FULL_N / DIST_TREE_SHARDS on UNCUT (Morton-sorted blocks), the tree of
# degree DIST_TREE_DEGREE against flat dist, over DIST_TREE_ROUNDS rounds
# of DIST_TREE_ROUND_N points.  BENCH_serve.json's rows replay
# benchmarks/serve.py's sequence (SERVE_BENCH_N points, the tier's
# SERVE_BENCH_QPS requests: the file was written with --qps) and must
# equal the file in SERVE_BENCH_FIELDS; the serve entry point's lines are
# compared without SERVE_TIMING_FIELDS.
DIST_TREE_SHARDS = 16
DIST_TREE_DEGREE = 4
DIST_TREE_ROUNDS = 4
DIST_TREE_ROUND_N = 1024
SERVE_BENCH_N = 2048
SERVE_BENCH_QPS = 96
SERVE_BENCH_FIELDS = ("n_live", "delta_bytes", "full_bytes", "delta_bytes_int8", "buffer_bytes",
                      "d2_pairs_delta", "d2_pairs_full", "query_shards_scanned",
                      "query_shards_possible", "n_clusters", "matches_host",
                      "delta_equals_full", "snapshot_matches_sync")
SERVE_TIMING_FIELDS = {"ingest_ms_per_batch", "query_ms", "match_ms_per_refresh",
                       "wall_ms_per_frame", "qps", "p50_ms", "p99_ms", "jit_cache_entries"}
# The tree of aggregators at full width (hierarchy_full_width): make_d2 at
# FULL_N, Morton-sorted, in HIER_SHARDS rings of HIER_SHARD_N (each shard a
# compact region, as a spatial partitioner gives it), on UNCUT (no local or
# node contour fills max_verts, where tree == flat is promised); the flat
# aggregator and trees of the HIER_DEGREES fed the same calls.  After the
# fit, HIER_ROUNDS rounds each ingest HIER_ROUND_N points of the same
# shard's block of a Morton-sorted make_d2 at DELTA_SEED into shard
# r * 4 mod HIER_SHARDS (the full ring evicts as many); every
# HIER_TTL_EVERY-th round expires the next HIER_TTL_STEP fit stamps of
# every shard (the fit stamps each point with its place in its block).
HIER_SHARDS = 64
HIER_SHARD_N = FULL_N // HIER_SHARDS
HIER_DEGREES = (4, 2)
HIER_ROUNDS = 16
HIER_ROUND_N = 1024
HIER_TTL_EVERY = 4
HIER_TTL_STEP = 64
# benchmarks/hierarchy.py's workload: its blob layout, configuration and
# BENCH_hierarchy.json's hardware-free fields.
BENCH_HIER_N = 8192
BENCH_HIER_BLOBS = 8
BENCH_HIER_CFG = dict(eps=0.03, min_pts=3, grid=48, max_clusters=8, max_verts=24)
BENCH_HIER_FIELDS = ("depth", "n_nodes", "n_clusters", "flat_refresh_bytes",
                     "hier_refresh_bytes", "flat_churn_bytes", "hier_churn_bytes",
                     "flat_bottleneck_bytes", "hier_bottleneck_bytes", "buffer_bytes",
                     "absorbed_steady", "maps_match", "valid_match", "sizes_match",
                     "root_d2_exact", "overflow")
# Cluster tracking at full width (tracking_full_width): BENCH_tracking.json's
# scaling row (eps 0.015, min_pts 3, grid 96, max_verts 96; 8 blobs of
# radius 0.02 moving 0.01 a step) at TRACK_FRAME_N points a frame in
# TRACK_SHARDS shards, TRACK_WINDOW + 1 frames live; 32 clusters a shard,
# so the tracker matches 256 × 256 slots.  Block-sparse DBSCAN on every
# run: the plain run (ops.FORCE = "ref", where "auto" takes the dense
# path) then takes the kernel run's path.
TRACK_STEPS = 24
TRACK_FRAME_N = 32_768
TRACK_BLOBS = 8
TRACK_SHARDS = 8
TRACK_WINDOW = 7
TRACK_CFG = dict(eps=0.015, min_pts=3, grid=96, max_verts=96, max_clusters=32,
                 block_sparse="always")
TRACK_RESUME_AT = 12
TRACK_V_TOL = 5e-3   # tests/test_tracking.py::test_velocity_and_heading_match_ground_truth
SPIN_CYCLES = 20_000_000  # ≈ 11 ms at 1.75 GHz: longer than the host takes to enqueue
CURATION_N = 262_144  # documents of the full-width curation run
DRYRUN_POINTS = 65_536  # the port's dry run (the reference's default is 1 << 20)
# The LM phase: every architecture of repro_torch.configs but granite-20b and
# deepseek-coder-33b (dense GQA/MQA as qwen3-8b), served at full width in
# this order.  For each, the kernel calls of its second run whose inputs the
# per-kernel checks take: {kernel: {call number within the run: label}}
# (whisper's calls: 12 encoder layers, then each decoder layer's self- and
# cross-attention, so 13 is layer 0's cross-attention in prefill and 36 its
# cross-attention in the first decode step; a one-MoE-layer model's gather
# call 1 is its first decode step).
LM_ARCHS = {
    "qwen3-8b": {"flash_attention": {0: "qwen3-8b prefill"}},
    "mamba2-1.3b": {"ssd_scan": {0: "mamba2-1.3b prefill"}},
    "llama4-scout-17b-a16e": {"dispatch_gather": {0: "llama4-scout prefill"}},
    "minicpm3-4b": {"flash_attention": {0: "minicpm3-4b prefill (MLA, d 96)"}},
    "whisper-small": {"flash_attention": {0: "whisper-small encoder",
                                          13: "whisper-small cross-attention, prefill",
                                          36: "whisper-small cross-attention, decode"}},
    "internvl2-26b": {"flash_attention": {0: "internvl2-26b prefill (prefix 256)"}},
    "kimi-k2-1t-a32b": {"dispatch_gather": {0: "kimi-k2 prefill", 1: "kimi-k2 decode"}},
    "jamba-1.5-large-398b": {"ssd_scan": {0: "jamba prefill"},
                             "dispatch_gather": {0: "jamba prefill", 1: "jamba decode"}},
}
# The first-layer inputs the main kernels-line entries are held on.
LM_MAIN_CAPTURE = {"flash_attention": "qwen3-8b prefill", "ssd_scan": "mamba2-1.3b prefill",
                   "dispatch_gather": "llama4-scout prefill"}
# Depth cuts by one card's 80 GB (ModelConfig.param_counts(), 1e9 bytes; the
# card holds about 85).  Each model's bf16 runs come first; then its weights
# are cast to float32 in place, a parameter at a time through the host
# (``cast_in_place``), for the float32 runs, so the two copies never sit on
# the card together:
# - llama4-scout: 48 layers are 216 GB in bf16; 4 layers and the embedding
#   and head 21.8 GB, 43.5 in float32.
# - internvl2-26b: 48 layers are 39.72 GB in bf16 and 79.45 in float32, which
#   leaves no room for the 4 x 2,304-token prefill's activations; 24 layers
#   are 21.00 / 42.00.
# - kimi-k2: one of its 61 layers (384 experts of 7,168 x 2,048, top-8, and a
#   shared expert) with the 163,840-entry embedding and head is 38.88 GB in
#   bf16 and 77.76 in float32; the float32 prefill's activations (its expert
#   buffer alone 82,176 x 7,168 x 4 bytes = 2.36 GB) fit in what is left only
#   because the MoE layer keeps few buffers alive at once (layers._moe_local).
# - jamba: one pattern group of 8 of its 72 layers (7 Mamba-2 + MLP layers,
#   one attention + 16-expert MoE layer) is 27.47 GB in bf16, 54.95 in float32.
# minicpm3-4b (62 layers, 8.52 GB in bf16) and whisper-small (12 + 12 layers,
# 0.50 GB) run at full depth.
LM_LAYERS = {"llama4-scout-17b-a16e": 4, "internvl2-26b": 24, "kimi-k2-1t-a32b": 1,
             "jamba-1.5-large-398b": 8}
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 2048, 16
# The training phase (lm_train): each model trained TRAIN_STEPS steps from
# the seed with the kernels and again with the plain versions (ops.FORCE =
# "ref"), float32 parameters, the reference's optimizer defaults, batches of
# TRAIN_BATCH × TRAIN_SEQ tokens from data/pipeline.py at seed 0, TF32 off;
# then one step with bf16 parameters.  Depth cuts by one card's 80 GB
# (ModelConfig.param_counts(), 1e9 bytes; the card holds about 85):
# - qwen3-8b, AdamW: float32 params + grads + m + v are 16 B a parameter; 8
#   of its 36 layers and the untied embedding and head are 2.79 B params,
#   44.6 GB, beside the activations of 2 × 2,048 tokens (about 1.6 GB a
#   layer) and the 2.5 GB float32 logits with their log-softmax and
#   gradient.
# - mamba2-1.3b, AdamW, 24 of its 48 layers: 0.72 B params, 11.6 GB of
#   float32 state, beside about 0.9 GB of activations a layer (all 48, 21.5
#   GB, fit too; the cut is one of time, so that the script ends within
#   its limit: the model's training took about 95 s at 48 layers).
# - llama4-scout, Adafactor, 1 of its 48 layers: every layer is MoE (16
#   experts top-1 and a shared one); one layer is 2.20 B params and the
#   embedding and head add 2.07 B.  AdamW's 16 B a parameter would need 68
#   GB before any activation; Adafactor keeps float32 params and grads and a
#   factored second moment, 34 GB in all (the reference's optimizer calls
#   it the memory answer for such configurations).  It runs the MoE aux
#   loss, B9's VJP and Adafactor.
# The plain runs checkpoint each block group (remat "full", which changes
# no value: tests/test_torch_models_grad.py holds it bit for bit): the
# plain chunked attention and SSD keep every chunk's intermediates for the
# backward pass (about 2.1 GB a qwen3-8b layer, 0.7 GB a mamba2 layer),
# which these depths leave no room for.  The kernel runs keep remat "none".
TRAIN_ARCHS = {"qwen3-8b": ("adamw", 8), "mamba2-1.3b": ("adamw", 24),
               "llama4-scout-17b-a16e": ("adafactor", 1)}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
# The checkpoint-resume check: mamba2-1.3b (the smallest state) at full
# width, cut to 4 of its 48 layers: 0.21 B params, 2.5 GB of float32
# params, m and v written and read back (on an H100 80GB HBM3 at 700 W, its
# full depth's 16.1 GB took 50–64 s to snapshot, write and restore, and 8
# layers' 3.7 GB 16 s).
TRAIN_CKPT_ARCH, TRAIN_CKPT_LAYERS = "mamba2-1.3b", 4
TRAIN_CKPT_RTOL = 1e-6  # where an op refuses deterministic algorithms
# Kernel run against plain run: each step's loss within LM_F32_TOL, gnorm
# within TRAIN_GNORM_RTOL relative, and after the last step each parameter
# tensor within TRAIN_PARAM_RTOL relative in norm (‖kernel − plain‖ ≤
# TRAIN_PARAM_RTOL · ‖plain‖).  The largest entry's relative error is
# reported, not gated: mamba2-1.3b's zero-initialised a_log and dt_bias are a
# few learning-rate steps from 0, where AdamW's normalisation magnifies the
# float32 noise of gradients near zero (on an H100 80GB HBM3: 1.4e-3 of the
# largest entry, 1.15e-8 absolute, 2.9e-4 in norm).
TRAIN_GNORM_RTOL = 1e-3
TRAIN_PARAM_RTOL = 5e-4
# The port's forward kernels by op, as the profiler names them.
TRAIN_KERNELS = {"flash_attention": ("flash_fwd_kernel", "flash_tc_kernel"),
                 "ssd_scan": ("ssd_scan_kernel", "ssd_tc_kernel"),
                 "dispatch_gather": ("gather_copy_kernel",)}
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
MLA_V_DIM = 64  # minicpm3-4b's v head dim, padded to its qk dim of 96
# tests/test_kernels.py's TestFlashAttention and TestSSDScan shapes, then
# ragged lengths, decode (sq = 1), the head-dim buckets' edges and the
# models' own heads in bf16; then the tensor-core route (bf16 at d 64, 96
# and 128) on GQA, MQA, non-causal, windowed, ragged (sq and skv not
# multiples of its 128-row tiles), sq < 64, a decode query against a cache,
# the (b, s, h, d) views that layers.gqa_qkv hands over ("bshd"), and MLA's
# layout ("mla": h = hkv, v 64 wide padded with zeros to the qk dim of 96,
# as layers.mla_apply pads it).  Each case held as the LM kernels are above,
# and on the route flash_attention.route picks.
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
    (1, 8, 2, 256, 256, 96, True, None, True, "bhsd"),      # d 96: causal square
    (1, 4, 4, 100, 173, 96, True, None, True, "bhsd"),      # ragged sq and skv
    (1, 2, 2, 300, 300, 96, True, 100, True, "bhsd"),       # window across tiles
    (2, 8, 8, 1, 300, 96, True, None, True, "bhsd"),        # one query against a cache
    (2, 8, 8, 200, 333, 96, True, None, True, "mla"),       # MLA's padded v
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


# Each LM kernel's source by the route it takes, and the TPU kernel it replaces.
LM_KERNEL_SOURCES = {("flash_attention", "tc"): "flash_attention_tc.cu",
                     ("flash_attention", "simt"): "flash_attention.cu",
                     ("ssd_scan", "tc"): "ssd_scan_tc.cu", ("ssd_scan", "simt"): "ssd_scan.cu",
                     ("dispatch_gather", "cuda"): "moe_gather.cu"}
LM_KERNEL_REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:99",
                      "ssd_scan": "src/repro/kernels/ssd_scan.py:78",
                      "dispatch_gather": "src/repro/kernels/moe_gather.py:48"}


def model_shape_entry(torch, ops, route_mod, kernel: str, label: str, args, kw,
                      model_launches: int) -> dict:
    """One LM kernel at a shape a model's main path gave it (``args``,
    ``kw`` as captured), through ``kernel_entry``: against the plain
    version ``ops`` runs under FORCE="ref" (the reference's routing off the
    TPU), bit for bit for the gather and within ``bf16_tol`` otherwise, two
    launches identical, on the route the kernel picks, timed beside the
    plain version and the library call (SDPA for attention,
    ``index_select`` for the gather, none for the SSD), with its bound:
    operations at the bf16 rate or bytes, each input read once and the
    output written once.  Attention on the tensor-core route is also held
    and timed on the CUDA-core kernel (``simt``), the route it replaced."""
    def kern():
        return getattr(ops, kernel)(*args, **kw)

    def plain():
        ops.FORCE = "ref"
        try:
            return getattr(ops, kernel)(*args, **kw)
        finally:
            ops.FORCE = None

    tol, extra = bf16_tol, {}
    if kernel == "flash_attention":
        q, k, v = args
        causal = kw.get("causal", True)
        b, h, sq, d = q.shape
        ops_n = b * h * _flash_pairs(sq, k.shape[2], causal) * 4 * d
        nbytes = tensor_bytes(q) * 2 + tensor_bytes(k) + tensor_bytes(v)
        route = route_mod.route(q.dtype, d)
        shape = [b, h, k.shape[1], sq, k.shape[2], d, str(q.dtype), "causal" if causal
                 else "non-causal"]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=kw.get("scale"), enable_gqa=True)

        if route == "tc":
            def simt():
                return route_mod._launch("simt", q, k, v, causal, kw.get("scale"),
                                         kw.get("window"))

            want = plain()
            simt_out = held(torch, f"{kernel} at {label} (CUDA cores)", simt(), want,
                            bf16_tol(want))
            del want
            extra["simt"] = {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                             "ms": median_ms(torch, simt, 5, per=2),
                             "max_abs_err": simt_out["max_abs_err"]}
    elif kernel == "ssd_scan":
        x, a, bb, c = args
        bsz, l, hs, dh = x.shape
        ds = bb.shape[-1]
        route = route_mod.route(x.dtype, dh, ds)
        lc = route_mod.CHUNK[route]
        ops_n = bsz * l * hs * ((lc + 1) * (ds + dh) + 4 * ds * dh)
        nbytes = tensor_bytes(x) * 2 + tensor_bytes(a) + tensor_bytes(bb) + tensor_bytes(c)
        shape = [bsz, l, hs, dh, ds, str(x.dtype)]
        library = None
    else:
        x, idx = args
        kept = int((idx >= 0).sum())
        ops_n = 0
        nbytes = kept * x.shape[1] * x.element_size() + idx.shape[0] * (
            4 + 4 + x.shape[1] * x.element_size())
        route, shape, tol = "cuda", [x.shape[0], x.shape[1], idx.shape[0], str(x.dtype)], None

        def library():
            return x.index_select(0, idx.clamp_min(0))

        def kern(_k=kern):
            return _k()[0]

        def plain(_p=plain):
            return _p()[0]
    b_ms, b_by = bound(ops_n, nbytes, PEAK_BF16)
    return kernel_entry(
        torch, kernel, LM_KERNEL_SOURCES[(kernel, route)], LM_KERNEL_REPLACES[kernel], shape,
        kern, plain, b_ms, b_by, model_launches, label, library=library, tol=tol,
        extra={"label": label, "kernel_route": route, "model_launches": model_launches,
               **two_launches(torch, f"{kernel} at {label}", kern),
               "operations": ops_n, "bytes": nbytes, **extra})


def lm_kernel_entries(torch, ops, ref, fa, ssd, captured: dict, by_model: dict,
                      lm_routes: dict, at_shapes: dict) -> list[dict]:
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
    the tensor-core route replaced there.  ``launches`` sums every LM
    model's main-path launches (``by_model``: {kernel: {model: launches}});
    ``at_model_shapes`` holds each kernel at the other shapes LM_ARCHS
    captured (``at_shapes``: ``model_shape_entry``'s, by kernel)."""
    launches = {k: sum(v.values()) for k, v in by_model.items()}
    routes = {"flash_attention": lm_routes["qwen3-8b"]["flash_attention"],
              "ssd_scan": lm_routes["mamba2-1.3b"]["ssd_scan"]}
    qwen_launches = by_model["flash_attention"]["qwen3-8b"]
    (q, k, v), _ = captured[("flash_attention", LM_MAIN_CAPTURE["flash_attention"])]
    b, h, s, d = q.shape
    hkv = k.shape[1]
    ops_fa = b * h * _flash_pairs(s, s, True) * 4 * d      # q·k and p·v, 2d each
    bytes_fa = tensor_bytes(q) * 2 + tensor_bytes(k) + tensor_bytes(v)   # q, k, v, out
    kind = fa.route(q.dtype, d)
    if kind != "tc" or routes["flash_attention"] != {"tc": qwen_launches, "simt": 0}:
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
        LM_KERNEL_REPLACES["flash_attention"], [b, h, hkv, s, d, str(q.dtype)],
        kern, plain, b_ms, b_by, launches["flash_attention"], "LM prefill (all models), "
        "whisper's and every cross-attention decode step; held on qwen3-8b's prefill",
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        tol=bf16_tol,
        extra={"kernel_route": kind, "route_launches": routes["flash_attention"],
               "launches_by_model": by_model["flash_attention"],
               "at_model_shapes": at_shapes["flash_attention"],
               "two_launches_identical": True,
               "bound_fp32_ms": bound(ops_fa, bytes_fa)[0], "operations": ops_fa,
               # p_hi and p_lo each multiply v: 1.5x the function's operations
               "tensor_core_operations": ops_fa * 3 // 2, "bytes": bytes_fa,
               "simt": {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "ms": median_ms(torch, simt, 5, per=2),
                        "max_abs_err": simt_out["max_abs_err"]},
               **f32_fa})]
    (x, a, bb, c), _ = captured[("ssd_scan", LM_MAIN_CAPTURE["ssd_scan"])]
    bsz, l, hs, dh = x.shape
    ds = bb.shape[-1]
    kind = ssd.route(x.dtype, dh, ds)
    if kind != "tc" or routes["ssd_scan"] != {"tc": by_model["ssd_scan"]["mamba2-1.3b"],
                                              "simt": 0}:
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
        torch, "ssd_scan", "ssd_scan_tc.cu", LM_KERNEL_REPLACES["ssd_scan"],
        [bsz, l, hs, dh, ds, str(x.dtype)], kern, plain, b_ms, b_by,
        launches["ssd_scan"], "mamba2-1.3b and jamba prefill; held on mamba2-1.3b's",
        tol=bf16_tol,
        extra={"kernel_route": kind, "route_launches": routes["ssd_scan"],
               "launches_by_model": by_model["ssd_scan"],
               "at_model_shapes": at_shapes["ssd_scan"],
               "two_launches_identical": True,
               "bound_fp32_ms": bound(ops_ssd, bytes_ssd)[0], "operations": ops_ssd,
               "tensor_core_operations": tc_ops, "bytes": bytes_ssd,
               "c_head_stride": c.stride(2), "chunk": lc,
               "simt": {"source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "ms": median_ms(torch, simt, 5, per=2),
                        "max_abs_err": simt_out["max_abs_err"]},
               **f32_ssd}))
    return entries


def moe_gather_entry(torch, ops, ref, captured: dict, by_model: dict,
                     at_shapes: dict) -> dict:
    """The MoE dispatch gather against its plain version on the inputs
    llama4-scout's prefill gave its first MoE layer: buf and scales bit
    for bit without quantisation in bf16 (as served) and cast up to
    float32, and int8 and scales with it; timed in both modes beside
    ``index_select`` of the same rows, which leaves out the empty-slot
    mask and the quantisation.  Bound by bytes: each kept row read once,
    the ids read and buf and the scales written once."""
    from repro_torch import configs

    (x, idx), _ = captured[("dispatch_gather", LM_MAIN_CAPTURE["dispatch_gather"])]
    launches = {k: sum(v.values()) for k, v in by_model.items()}
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
        torch, "dispatch_gather", "moe_gather.cu", LM_KERNEL_REPLACES["dispatch_gather"], shape,
        lambda: ops.dispatch_gather(x, idx, quant=False)[0],
        lambda: ref.dispatch_gather(x, idx, quant=False)[0], *bound(0, copy_bytes),
        launches["dispatch_gather"], "llama4-scout, kimi-k2 and jamba prefill and decode; "
        "held on llama4-scout's prefill", library=library,
        extra={"bytes": copy_bytes, "kept_rows": kept, "bit_identical": checks,
               "launches_by_model": by_model["dispatch_gather"],
               "at_model_shapes": at_shapes["dispatch_gather"],
               "library": "index_select (no mask, no quantisation)"})
    q = kernel_entry(
        torch, "dispatch_gather_int8", "moe_gather.cu", LM_KERNEL_REPLACES["dispatch_gather"],
        shape, lambda: ops.dispatch_gather(x, idx, quant=True)[0],
        lambda: ref.dispatch_gather(x, idx, quant=True)[0], *bound(quant_ops, quant_bytes),
        0, "the MoE a2a island's send buffer (lm_mesh); none on the serving path",
        library=library,
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
        if layout == "mla":  # v of MLA_V_DIM columns padded with zeros to d
            v = torch.nn.functional.pad(v[..., :MLA_V_DIM], (0, d - MLA_V_DIM))
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


def cast_in_place(torch, model, dtype) -> None:
    """Cast every parameter of ``model`` to ``dtype`` in place, one at a
    time: a parameter too large to have both copies on the card beside
    the rest goes to the host first and comes back in chunks of about
    1 GB, each cast on the card, so the card holds no more than the model
    in ``dtype`` at its end."""
    for p in model.parameters():
        src, dev = p.data, p.device
        out_bytes = src.numel() * torch.empty((), dtype=dtype).element_size()
        if torch.cuda.mem_get_info(dev)[0] > out_bytes + (2 << 30):
            p.data = src.to(dtype)
            del src
        else:
            host = src.cpu()
            del src
            p.data = torch.empty((), device=dev)   # its old storage is freed here
            torch.cuda.empty_cache()
            p.data = torch.empty_like(host, dtype=dtype, device=dev)
            rows = max(1, (1 << 30) // max(1, host[:1].numel() * 4))
            for i in range(0, host.shape[0], rows):
                p.data[i:i + rows].copy_(host[i:i + rows].to(dev))
            del host
        torch.cuda.empty_cache()


def lm_extras(torch, cfg, dev) -> dict:
    """The inputs beside the prompt a configuration serves with, seeded, in
    bf16 as the weights: an encoder-decoder's frames (LM_BATCH,
    frontend_seq, d) and a VLM's prefix (LM_BATCH, prefix_len, d), normal ·
    0.1 as the reference's ``launch/serve.py`` draws them."""
    g = torch.Generator(device=dev).manual_seed(2)
    out = {}
    if cfg.frontend == "audio_stub":
        out["frames"] = (torch.randn((LM_BATCH, cfg.frontend_seq, cfg.d_model), generator=g,
                                     device=dev) * 0.1).bfloat16()
    if cfg.prefix_len:
        out["prefix"] = (torch.randn((LM_BATCH, cfg.prefix_len, cfg.d_model), generator=g,
                                     device=dev) * 0.1).bfloat16()
    return out


def forced_run(torch, ops, engine, cfg, scfg, model, prompt, toks, extras, *, plain: bool):
    """Prefill ``prompt`` (with ``extras``: frames or prefix), then decode
    teacher-forced on ``toks``: each step's logits (prefill's first), with
    the kernels or (``plain``) the plain versions, which must launch no
    kernel; and the prefill's wall time."""
    before = ops.launch_counts()
    ops.FORCE = "ref" if plain else None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, pos = engine.build_prefill(cfg, scfg)(model, prompt, **extras)
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


def lm_cli_runs(torch, ops) -> dict:
    """``repro_torch.launch.serve --mode lm`` on the card: every
    architecture's tiny configuration in this process (its float32 path's
    kernel launches, zeroed before each run and read after, must follow
    ``lm_launch_plan``), then whisper-small at full width as its own
    process (``python -m``, the default mode).  Each line must carry the
    reference's keys and the device, and tokens in the vocabulary."""
    from repro_torch import configs
    from repro_torch.launch import serve

    keys = {"requests", "generated_tokens", "wall_s", "tok_per_s", "sample_output", "device"}
    gen = 8
    out = {}
    for arch in configs.all_archs():
        cfg = configs.get_config(arch)
        ops.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            toks = serve.main(["--mode", "lm", "--arch", arch, "--tiny", "--gen", str(gen)])
        torch.cuda.synchronize()
        launches = {k: n for k, n in ops.launch_counts().items() if n}
        plan = {k: n for k, n in lm_launch_plan(cfg.tiny(), gen).items() if n}
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        if launches != plan or set(line) != keys or line["device"] != "cuda" \
                or toks.shape != (4, gen) or int(toks.max()) >= cfg.vocab:
            raise RuntimeError(f"serve --mode lm --arch {arch} --tiny: launches {launches} "
                               f"(plan {plan}), line {line}")
        out[arch] = {"launches": launches, "tok_per_s": line["tok_per_s"]}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "whisper-small"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode != 0:
        raise RuntimeError(f"serve --mode lm --arch whisper-small: {proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    vocab = configs.get_config("whisper-small").vocab
    if set(line) != keys or line["device"] != "cuda" or max(line["sample_output"]) >= vocab:
        raise RuntimeError(f"serve --mode lm --arch whisper-small: {line}")
    out["whisper-small full width"] = line
    return out


def lm_launch_plan(cfg, steps: int = LM_STEPS) -> dict[str, int]:
    """The launches one greedy_generate of ``steps`` tokens makes, by kernel:
    flash_attention once per attention layer in prefill, and for an
    encoder-decoder once per encoder layer and per decoder layer's
    cross-attention in prefill and in each of the ``steps`` − 1 decode steps;
    ssd_scan once per Mamba layer, in prefill only; dispatch_gather once
    per MoE layer in prefill and in each decode step."""
    kinds = cfg.layer_kinds()

    def layers(pred) -> int:
        return cfg.n_groups * sum(1 for kind, is_moe in kinds if pred(kind, is_moe))

    cross = cfg.n_layers if cfg.encoder_layers else 0
    return {"flash_attention": layers(lambda kind, _: kind == "attn") + cfg.encoder_layers
            + cross * steps,
            "ssd_scan": layers(lambda kind, _: kind == "mamba"),
            "dispatch_gather": layers(lambda _, is_moe: is_moe) * steps}


def attention_head_dim(cfg) -> int:
    """The head dim flash_attention gets: nope + rope under MLA (v padded to
    it), the head dim otherwise."""
    return cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.attn_kind == "mla" else cfg.head_dim


@contextlib.contextmanager
def capture_calls(ops, wanted: dict, captured: dict):
    """While active, the calls of ``ops``' kernels numbered in ``wanted``
    ({kernel: {call number: label}}) store their arguments in
    ``captured[(kernel, label)]`` = (args, kwargs)."""
    origs = {name: getattr(ops, name) for name in wanted}
    for name, calls in wanted.items():
        seen = [0]

        def wrap(*args, _orig=origs[name], _name=name, _calls=calls, _seen=seen, **kw):
            if _seen[0] in _calls:
                captured[(_name, _calls[_seen[0]])] = (args, kw)
            _seen[0] += 1
            return _orig(*args, **kw)

        setattr(ops, name, wrap)
    try:
        yield
    finally:
        for name, orig in origs.items():
            setattr(ops, name, orig)


@contextlib.contextmanager
def record_routes(L):
    """While active, every MoE layer's routing (its top-k experts and which
    token-copies it kept) is appended to the yielded list, in call order:
    prefill's MoE layers, then each decode step's."""
    calls, orig = [], L._route

    def route(probs, k, capacity, *experts):
        r = orig(probs, k, capacity, *experts)
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

    def route(probs, k, capacity, *experts):
        step = next(logged, None)
        if step is None or step[0].shape != (probs.shape[0], k):
            raise RuntimeError("replayed routing: the MoE calls do not line up with the log")
        r = L.route_given(probs, step[0], capacity, *experts)
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


def lm_phase(torch, dev, card: str) -> tuple[dict, dict, dict, dict]:
    """Serve each LM_ARCHS model at full width, at full depth or cut to
    LM_LAYERS (see the module docstring), and print its numbers.  Returns
    ({kernel: {model: main-path launches}}, {(kernel, label): (args,
    kwargs) of the LM_MAIN_CAPTURE calls}, {model: {kernel: main-path
    launches by route}} for flash_attention and ssd_scan, {kernel:
    [``model_shape_entry`` of each other call LM_ARCHS names]}).  The
    other calls are held and timed right after their model's kernel runs,
    and their inputs dropped, so that they take no room from the later
    models."""
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
    at_shapes = {"flash_attention": [], "ssd_scan": [], "dispatch_gather": []}
    route_mods = {"flash_attention": fa, "ssd_scan": ssd, "dispatch_gather": None}
    for arch, wanted in LM_ARCHS.items():
        published = configs.get_config(arch)
        cfg = dataclasses.replace(published, n_layers=LM_LAYERS.get(arch, published.n_layers))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                              dtype=torch.bfloat16)
        prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        extras = lm_extras(torch, cfg, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        scfg = engine.ServeConfig(max_len=LM_PROMPT + LM_STEPS + cfg.prefix_len)
        n_params = sum(p.numel() for p in model.parameters())

        # Two kernel runs: the first counted, the second (warm, so its times
        # are the ones reported) captures the kernel inputs LM_ARCHS names
        # and logs the MoE routing; both must agree bit for bit.
        runs = []
        for i in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            tr: dict = {}
            with capture_calls(ops, wanted if i == 1 else {}, captured), \
                    record_routes(L) as routes_k:
                toks = engine.greedy_generate(cfg, model, prompt, LM_STEPS, scfg, trace=tr,
                                              **extras)
            torch.cuda.synchronize()
            runs.append((toks, tr, ops.launch_counts(), route_counts(fa, ssd),
                         torch.cuda.max_memory_allocated(dev)))
        (toks, tr, launches, routes, peak), (toks2, tr2, _, _, _) = runs
        plan = lm_launch_plan(cfg)
        want = {k: plan.get(k, 0) for k in launches}
        log(f"{arch}: launches {launches}, routes {routes}, prefill "
            f"{tr['prefill_s']:.4f}s, decode {tr['decode_s']:.4f}s")
        if launches != want:
            raise RuntimeError(f"{arch}: launches {launches}, expected {want} (attention and "
                               "SSD once per layer in prefill, cross-attention and the MoE "
                               "gather also in every decode step)")
        missing = [(k, lbl) for k, calls in wanted.items() for lbl in calls.values()
                   if (k, lbl) not in captured]
        if missing:
            raise RuntimeError(f"{arch}: the kernel calls {missing} were not made")
        # bf16 weights: every attention and SSD launch takes the route its
        # shape gets in bf16 (fa.route, ssd.route): the tensor cores at
        # attention's d 64 and 128, at MLA's qk dim of 96 (minicpm3-4b's 62
        # prefill launches) and at the SSD's (dh, ds) = (64, 128).
        want_routes = {k: {"tc": 0, "simt": 0} for k in routes}
        want_routes["flash_attention"][fa.route(torch.bfloat16, attention_head_dim(cfg))] += \
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
        for kernel, calls in wanted.items():
            for label in calls.values():
                if label != LM_MAIN_CAPTURE[kernel]:
                    args, kw = captured.pop((kernel, label))
                    at_shapes[kernel].append(model_shape_entry(
                        torch, ops, route_mods[kernel], kernel, label, args, kw,
                        launches[kernel]))
                    del args, kw

        # One more prefill and one decode step under the profiler: device
        # time by kernel.
        prof = {"prefill": profile_fn(torch, lambda: engine.build_prefill(cfg, scfg)(
            model, prompt, **extras), tr2["prefill_s"])}
        _, cache_p, pos_p = engine.build_prefill(cfg, scfg)(model, prompt, **extras)
        prof["decode_step"] = profile_fn(torch, lambda: engine.build_decode(cfg, scfg)(
            model, toks[:, :1], cache_p, pos_p), tr2["decode_s"] / (LM_STEPS - 1))
        del cache_p

        # The plain run of the same path, teacher-forced on the kernel run's
        # tokens, in bf16 and routed by the kernel run's decisions (replayed
        # from its route log, the gates from the plain run's own
        # probabilities): where the two bf16 runs would route a token
        # differently, the bf16 gate would measure that flip, not the
        # kernel.  For a MoE model the plain run is also made unreplayed,
        # to report how often it routes otherwise.  Then the weights are
        # cast to float32 in place and both runs made again, each logging its
        # own routing, call for call beside the kernel run's.
        with replay_routes(L, routes_k) as routes_p:
            plain, plain_prefill_s = forced_run(torch, ops, engine, cfg, scfg, model, prompt,
                                                toks, extras, plain=True)
        if len(routes_p) != len(routes_k):
            raise RuntimeError(f"{arch}: the replayed plain run made {len(routes_p)} MoE calls, "
                               f"the kernel run {len(routes_k)}")
        plain_u, routes_u = plain, routes_p
        if routes_k:
            with record_routes(L) as routes_u:
                plain_u, _ = forced_run(torch, ops, engine, cfg, scfg, model, prompt, toks,
                                        extras, plain=True)
        torch.cuda.synchronize()
        t_cast = time.perf_counter()
        cast_in_place(torch, model, torch.float32)
        cast_s = time.perf_counter() - t_cast
        before32 = route_counts(fa, ssd)
        torch.cuda.reset_peak_memory_stats(dev)
        with record_routes(L) as routes_k32:
            kern32, _ = forced_run(torch, ops, engine, cfg, scfg, model, prompt, toks, extras,
                                   plain=False)
        routes32 = {k: {r: n - before32[k][r] for r, n in v.items()}
                    for k, v in route_counts(fa, ssd).items()}
        if routes32 != {k: {"tc": 0, "simt": plan[k]} for k in routes32}:
            raise RuntimeError(f"{arch}: the float32 run's launches by route {routes32}: "
                               "float32 must stay on the CUDA cores")
        with record_routes(L) as routes_p32:
            plain32, _ = forced_run(torch, ops, engine, cfg, scfg, model, prompt, toks, extras,
                                    plain=True)
        peak32 = torch.cuda.max_memory_allocated(dev)
        del model
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
        for k, n in launches.items():
            if n:
                launches_by_kernel.setdefault(k, {})[arch] = n
        lm_routes[arch] = routes
        decode_tokens = LM_BATCH * (LM_STEPS - 1)
        numbers = {
            "card": card, "layers": cfg.n_layers, "published_layers": published.n_layers,
            "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
            "attention_head_dim": attention_head_dim(cfg),
            "extras": {k: list(v.shape) for k, v in extras.items()},
            "params": n_params, "param_dtype": "bfloat16", "batch": LM_BATCH,
            "prompt": LM_PROMPT, "steps": LM_STEPS, "max_len": scfg.max_len,
            "init_s": init_s, "prefill_s": tr2["prefill_s"],
            "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / tr2["prefill_s"],
            "decode_s": tr2["decode_s"],
            "decode_ms_per_token": tr2["decode_s"] / (LM_STEPS - 1) * 1e3,
            "decode_tokens_per_s": decode_tokens / tr2["decode_s"],
            "first_run_prefill_s": tr["prefill_s"], "first_run_decode_s": tr["decode_s"],
            "plain_prefill_s": plain_prefill_s, "peak_mem_gb": peak / 1e9,
            "f32_cast_s": cast_s, "f32_peak_mem_gb": peak32 / 1e9,
            "launches": launches, "launch_plan": plan,
            "flash_attention_routes": routes["flash_attention"],
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
        del tr, tr2, runs, toks, toks2, plain, plain_u, kern32, plain32, extras, prompt
        torch.cuda.empty_cache()
    return launches_by_kernel, captured, lm_routes, at_shapes


def flat_named(tree) -> list[tuple[str, object]]:
    """(name, tensor) of a tree (``models/tree.py``) in flatten order, each
    ``Stack`` opened into its groups' tensors (``path[g]``)."""
    from repro_torch.models.tree import Stack, flatten

    out = []
    for path, leaf in flatten(tree):
        name = "/".join(path)
        if isinstance(leaf, Stack):
            out.extend((f"{name}[{g}]", t) for g, t in enumerate(leaf))
        else:
            out.append((name, leaf))
    return out


def flat_tensors(tree) -> list:
    return [t for _, t in flat_named(tree)]


def host_copies(ckpt_mod, tensors) -> list:
    """Host copies (array, dtype name) of card tensors, through one pinned
    staging buffer (``checkpoint.Stager``)."""
    stager = ckpt_mod.Stager()
    return [(stager.to_host(t), str(t.dtype).removeprefix("torch.")) for t in tensors]


def device_copies(ckpt_mod, items, dev):
    """The card tensors of ``host_copies``' items, one at a time."""
    stager = ckpt_mod.Stager()
    for arr, dtype in items:
        yield stager.to_device(arr, dtype, dev)


def train_batches(torch, cfg, dev) -> list[dict]:
    """The TRAIN_STEPS batches of TRAIN_BATCH × TRAIN_SEQ tokens the runs
    train on: ``data/pipeline.py``'s batches 0, 1, ... at seed 0, on the card."""
    from repro_torch.data import pipeline

    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                               seed=0, frontend=cfg.frontend, frontend_seq=cfg.frontend_seq,
                               prefix_len=cfg.prefix_len, d_model=cfg.d_model)
    return [{k: torch.as_tensor(v, device=dev) for k, v in pipeline.batch_at(dcfg, i).items()}
            for i in range(TRAIN_STEPS)]


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` while
    active; yields a function that lists the ops that refused it so far
    (the first line of each such warning)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield lambda: sorted({str(w.message).splitlines()[0][:160] for w in caught
                                  if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)


def train_profile(torch, ops, fn, wall_s: float) -> dict:
    """One train step ``fn`` under torch.profiler (the card's activity
    only: recording every host op of mamba2-1.3b's step as well took 87 s
    on an H100 80GB HBM3's host): device ms by kernel (the top 8), of the
    port's forward kernels (TRAIN_KERNELS' names) and of the GEMMs, and the
    busy share of ``wall_s`` (the unprofiled step's time).  The plain versions' recompute
    in the backward pass is timed by CUDA events around each
    ``ops._plain_vjp`` call (its span on the card, idle gaps inside it
    included), as a share of ``wall_s``."""
    from torch.profiler import ProfilerActivity, profile

    spans, orig = [], ops._plain_vjp

    def timed(name, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(name, *args, **kw)
        end.record()
        spans.append((name, start, end))
        return out

    ops._plain_vjp = timed
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        ops._plain_vjp = orig
    vjp: dict = {}
    for name, start, end in spans:
        ms, n = vjp.get(name, (0.0, 0))
        vjp[name] = (ms + start.elapsed_time(end), n + 1)
    vjp_ms = sum(ms for ms, _ in vjp.values())
    rows = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, count = rows.get(_short(e.key), (0.0, 0))
        rows[_short(e.key)] = (ms + e.self_device_time_total / 1e3, count + e.count)
    out = {"wall_s": wall_s, "plain_vjp_ms": {op: ms for op, (ms, _) in vjp.items()},
           "plain_vjp_calls": {op: n for op, (_, n) in vjp.items()},
           "plain_vjp_share": vjp_ms / 1e3 / wall_s}
    if not rows:
        return {**out, "device_ms": "not measured"}
    device_ms = sum(ms for ms, _ in rows.values())
    gemm_ms = sum(ms for k, (ms, _) in rows.items()
                  if any(w in k.lower() for w in ("gemm", "xmma", "cutlass", "cublas")))
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]
    return {**out, "device_ms": device_ms, "busy_share": device_ms / 1e3 / wall_s,
            "device_calls": sum(c for _, c in rows.values()),
            "forward_kernels_ms": {op: sum(rows.get(k, (0.0, 0))[0] for k in names)
                                   for op, names in TRAIN_KERNELS.items()},
            "gemm_ms": gemm_ms, "gemm_share": gemm_ms / device_ms,
            "top": [{"name": k, "ms": ms, "calls": c} for k, (ms, c) in ranked]}


def train_steps(torch, ops, step_mod, par, cfg, tcfg, batches, dev, *, plain: bool,
                on_step=None):
    """TRAIN_STEPS steps of ``build_train_step`` from the seed, with the
    kernels or (``plain``) the plain versions, which launch no kernel and
    checkpoint each block group (remat "full": see TRAIN_ARCHS).  Returns
    (state, per-step metrics, launches, launches by route, peak bytes).
    ``on_step(i, state)`` runs after step i, and with i = −1 before the
    first step."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    step_fn = step_mod.build_train_step(cfg, tcfg, par.ParallelCtx(
        remat="full" if plain else "none"))
    state = step_mod.make_train_state(cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    ops.FORCE = "ref" if plain else None
    steps = []
    try:
        if on_step is not None:
            on_step(-1, state)
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t0, "loss": float(m["loss"]),
                          "gnorm": float(m["gnorm"]), "lr": float(m["lr"])})
            if on_step is not None:
                on_step(i, state)
    finally:
        ops.FORCE = None
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    if plain and launches:
        raise RuntimeError(f"{cfg.name}: the plain training run launched {launches}")
    return state, steps, launches, route_counts(fa, ssd), torch.cuda.max_memory_allocated(dev)


@contextlib.contextmanager
def step_grads(step_mod, keep):
    """While active, the gradients the next train step hands the optimizer
    (``step_mod.opt_mod.apply_updates``) are passed, in flatten order, to
    ``keep``, once."""
    orig, done = step_mod.opt_mod.apply_updates, []

    def apply_updates(cfg, grads, *args, **kw):
        if not done:
            done.append(True)
            keep(flat_tensors(grads))
        return orig(cfg, grads, *args, **kw)

    step_mod.opt_mod.apply_updates = apply_updates
    try:
        yield
    finally:
        step_mod.opt_mod.apply_updates = orig


def plain_grads(torch, ops, step_mod, par, cfg, tcfg, model, batch):
    """(loss, gradients in flatten order) of ``batch`` at ``model``'s
    parameters, on the plain versions (remat "full")."""
    ops.FORCE = "ref"
    try:
        with par.use(par.ParallelCtx(remat="full")):
            loss, grads = step_mod._loss_and_grads(cfg, tcfg, model, batch)
    finally:
        ops.FORCE = None
    return float(loss), flat_tensors(grads)


def token_nll(torch, T, cfg, model, batch):
    """Each next token's NLL (B, S − 1), float32, as ``loss_fn`` takes their
    mean (without the MoE aux term), under ``torch.no_grad``."""
    with torch.no_grad():
        logits, _ = T.forward(cfg, model, batch["tokens"], prefix=batch.get("prefix"),
                              frames=batch.get("frames"))
        logits = logits.float()
        if cfg.padded_vocab != cfg.vocab:
            pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
            logits = torch.where(pad, -1e30, logits)
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        return -lp.gather(-1, batch["tokens"][:, 1:].long()[..., None])[..., 0]


def rms_dist(torch, a, b) -> float:
    return float((a.double() - b.double()).pow(2).mean().sqrt())


def grad_rms(torch, ckpt_mod, grads: list, ref_host: list) -> float:
    """RMS over every element of (gradient − the reference's, in float32);
    the reference as ``host_copies``' items."""
    total, n = 0.0, 0
    for g, r in zip(grads, device_copies(ckpt_mod, ref_host, grads[0].device)):
        d = g.float() - r
        total += float(torch.sum(d * d, dtype=torch.float64))
        n += d.numel()
    return math.sqrt(total / n)


def leaf_errs(torch, ckpt_mod, named: list, want_host: list) -> list[dict]:
    """Each tensor of ``named`` ((name, card tensor)) against its host copy
    (``host_copies``' item): max |got − want| / max |got|, and the relative
    norm ‖got − want‖ / ‖got‖; bit-identical or not."""
    out = []
    for (name, g), w in zip(named, device_copies(ckpt_mod, want_host, named[0][1].device)):
        g = g.detach()
        exact = bool(torch.equal(g, w))
        g, w = g.double(), w.double()
        scale, norm = float(g.abs().max()), float(g.norm())
        d = g - w
        err, dnorm = float(d.abs().max()), float(d.norm())
        out.append({"name": name, "exact": exact, "max_abs": scale, "max_abs_err": err,
                    "rel_max": err / scale if scale else err,
                    "rel_norm": dnorm / norm if norm else dnorm})
        del g, w, d
    return out


def train_model(torch, dev, card: str, arch: str, opt_name: str, layers) -> dict:
    """One model of TRAIN_ARCHS at full width (module docstring): the
    kernel run, a profiled step, the plain run, the bf16 step.  Returns its
    line, whose ``failures`` lists the gates it failed (a wrong launch
    count or route raises)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    published = configs.get_config(arch)
    cfg = dataclasses.replace(published, n_layers=layers or published.n_layers)
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(name=opt_name))
    batches = train_batches(torch, cfg, dev)
    plan = {k: n for k, n in lm_launch_plan(cfg, 1).items() if n}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    t_phase = time.perf_counter()
    sections, t_mark, failures = {}, [t_phase], []

    def mark(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        sections[name] = now - t_mark[0]
        t_mark[0] = now

    state, steps, launches, routes, peak = train_steps(
        torch, ops, step_mod, par, cfg, tcfg, batches, dev, plain=False)
    want = {k: n * TRAIN_STEPS for k, n in plan.items()}
    want_routes = {k: {"tc": 0, "simt": want.get(k, 0)} for k in routes}
    log(f"{arch} train: {steps}, launches {launches}, routes {routes}, peak {peak / 1e9} GB")
    if launches != want or routes != want_routes:
        raise RuntimeError(f"{arch}: the kernel run launched {launches} by route {routes}; "
                           f"expected {want} on the CUDA cores (float32)")
    mark("kernel_run")
    final = host_copies(ckpt_mod, flat_tensors(state.params))
    n_params = sum(a.size for a, _ in final)
    mark("host_copy")

    # One more step under the profiler, against the kernel run's median
    # unprofiled step time.
    step_fn = step_mod.build_train_step(cfg, tcfg, par.ParallelCtx())
    prof = train_profile(torch, ops, lambda: step_fn(state, batches[0]),
                         statistics.median(x["s"] for x in steps[1:]))
    log(f"{arch} profiled step: {prof}")
    del state, step_fn
    torch.cuda.empty_cache()
    mark("profile")

    # The plain run; its first step's gradient and each token's NLL at the
    # seed's parameters are the bf16 gate's float32 reference.
    ref32 = {}

    def at_init(i, state):
        if i == -1:
            ref32["nll"] = token_nll(torch, T, cfg, state.params, batches[0])

    with step_grads(step_mod, lambda g: ref32.setdefault("grads", host_copies(ckpt_mod, g))):
        pstate, psteps, _, _, ppeak = train_steps(torch, ops, step_mod, par, cfg, tcfg, batches,
                                                  dev, plain=True, on_step=at_init)
    loss32, grads32, nll32 = psteps[0]["loss"], ref32["grads"], ref32["nll"]
    loss_errs = [abs(a["loss"] - b["loss"]) for a, b in zip(steps, psteps)]
    gnorm_errs = [abs(a["gnorm"] - b["gnorm"]) / b["gnorm"] for a, b in zip(steps, psteps)]
    param_errs = leaf_errs(torch, ckpt_mod, flat_named(pstate.params), final)
    worst = sorted(param_errs, key=lambda e: -e["rel_norm"])[:4]
    log(f"{arch} plain: {psteps}; loss errs {loss_errs}, gnorm rel {gnorm_errs}, params "
        f"worst {worst}")
    rtol, atol = LM_F32_TOL
    if not all(e <= atol + rtol * abs(b["loss"]) for e, b in zip(loss_errs, psteps)):
        failures.append(f"training losses differ beyond {LM_F32_TOL}: {loss_errs}")
    if not max(gnorm_errs) <= TRAIN_GNORM_RTOL:
        failures.append(f"gnorm differs by {gnorm_errs} relative")
    if not worst[0]["rel_norm"] <= TRAIN_PARAM_RTOL:
        failures.append(f"parameters differ from the plain run's beyond {TRAIN_PARAM_RTOL}: "
                        f"{worst}")
    del pstate, final
    torch.cuda.empty_cache()
    mark("plain_run")

    # bf16 parameters: the gradient and each token's NLL at the seed's
    # parameters on the plain versions, then with the kernels (the first
    # step's), each against the float32 plain run's; the step runs the
    # tensor-core routes inside training.
    tcfg16 = dataclasses.replace(tcfg, param_dtype="bfloat16")
    s16 = step_mod.make_train_state(cfg, tcfg16, device=dev)
    loss_p, grads_p = plain_grads(torch, ops, step_mod, par, cfg, tcfg16, s16.params, batches[0])
    ops.FORCE = "ref"
    try:
        nll_p = token_nll(torch, T, cfg, s16.params, batches[0])
    finally:
        ops.FORCE = None
    dist_p = {"token_nll_rms": rms_dist(torch, nll_p, nll32),
              "grad_rms": grad_rms(torch, ckpt_mod, grads_p, grads32)}
    del grads_p, nll_p
    nll_k = token_nll(torch, T, cfg, s16.params, batches[0])
    step_fn = step_mod.build_train_step(cfg, tcfg16, par.ParallelCtx())
    before = route_counts(fa, ssd)
    kept = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with step_grads(step_mod, kept.append):
        s16, m16 = step_fn(s16, batches[0])
    torch.cuda.synchronize()
    step16_s = time.perf_counter() - t0
    routes16 = {k: {r: n - before[k][r] for r, n in v.items()}
                for k, v in route_counts(fa, ssd).items()}
    dist_k = {"token_nll_rms": rms_dist(torch, nll_k, nll32),
              "grad_rms": grad_rms(torch, ckpt_mod, kept[0], grads32)}
    loss_dist = {"kernel": abs(float(m16["loss"]) - loss32), "plain": abs(loss_p - loss32)}
    del kept, grads32, nll_k, nll32
    log(f"{arch} bf16: kernel {dist_k}, plain {dist_p}, mean loss {loss_dist}, "
        f"routes {routes16}")
    want16 = {k: {"tc": 0, "simt": 0} for k in routes16}
    for k, n in plan.items():
        if k in want16:
            d = attention_head_dim(cfg) if k == "flash_attention" else None
            r = (fa.route(torch.bfloat16, d) if k == "flash_attention"
                 else ssd.route(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state))
            want16[k][r] = n
    if routes16 != want16:
        raise RuntimeError(f"{arch}: the bf16 forward took routes {routes16}, expected {want16}")
    if not all(dist_k[k] <= LM_BF16_NOISE * dist_p[k] for k in dist_k):
        failures.append(f"the bf16 kernel run is {dist_k} from the float32 run, more than "
                        f"{LM_BF16_NOISE} x the plain bf16 run's {dist_p}")
    if not (math.isfinite(float(m16["loss"])) and math.isfinite(float(m16["gnorm"]))):
        failures.append(f"the bf16 step's loss, gnorm are {float(m16['loss'])}, "
                        f"{float(m16['gnorm'])}")
    del s16, step_fn
    torch.cuda.empty_cache()
    mark("bf16")

    warm = steps[1:]
    line = {
        "card": card, "layers": cfg.n_layers, "published_layers": published.n_layers,
        "d_model": cfg.d_model, "optimizer": opt_name, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps, "plain_steps": psteps,
        "step_s": statistics.median(s["s"] for s in warm),
        "tokens_per_s": tokens / statistics.median(s["s"] for s in warm),
        "plain_step_s": statistics.median(s["s"] for s in psteps[1:]),
        "peak_mem_gb": peak / 1e9, "plain_peak_mem_gb": ppeak / 1e9,
        "launches_per_step": {k: n // TRAIN_STEPS for k, n in launches.items()},
        "routes": routes, "profile": prof,
        "loss_abs_err": loss_errs, "loss_tolerance": list(LM_F32_TOL),
        "gnorm_rel_err": gnorm_errs, "gnorm_tolerance": TRAIN_GNORM_RTOL,
        "param_rel_norm_err": worst[0]["rel_norm"], "param_tolerance": TRAIN_PARAM_RTOL,
        "param_max_rel_err": max(e["rel_max"] for e in param_errs),
        "param_worst": worst,
        "params_bit_identical": sum(e["exact"] for e in param_errs),
        "param_tensors": len(param_errs),
        "bf16": {"kernel_vs_f32": dist_k, "plain_vs_f32": dist_p, "routes": routes16,
                 "mean_loss_vs_f32": loss_dist,
                 "noise_factor": LM_BF16_NOISE, "step_s": step16_s,
                 "loss": float(m16["loss"]), "gnorm": float(m16["gnorm"])},
        "sections_s": sections, "failures": failures,
        "phase_s": time.perf_counter() - t_phase}
    return line


def train_cli_runs(torch, ops) -> dict:
    """``repro_torch.launch.train`` on the card: tiny qwen3-8b for 10 steps
    with checkpoints every 5, then ``--resume`` to 20 (it must resume at
    step 10), and an uninterrupted 20-step run, whose last 10 losses the
    resumed run must give within 1e-6 relative; each run's launches follow
    the plan (attention once per layer a step).  Then
    ``examples/train_lm_torch.py --steps 20`` as its own process."""
    from repro_torch import configs
    from repro_torch.launch import train as train_mod

    tiny = configs.get_config("qwen3-8b").tiny()
    per_step = lm_launch_plan(tiny, 1)["flash_attention"]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        base = ["--arch", "qwen3-8b", "--tiny", "--log-every", "5"]
        runs = {}
        for name, extra, steps in (("first", ["--ckpt-dir", d, "--ckpt-every", "5"], 10),
                                   ("resumed", ["--ckpt-dir", d, "--resume"], 10),
                                   ("uninterrupted", [], 20)):
            n_steps = 20 if name != "first" else 10
            ops.reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                losses = train_mod.main(base + ["--steps", str(n_steps)] + extra)
            torch.cuda.synchronize()
            text = buf.getvalue()
            lines = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
            launches = {k: n for k, n in ops.launch_counts().items() if n}
            if launches != {"flash_attention": per_step * steps} or len(losses) != steps \
                    or not all(math.isfinite(x) for x in losses) \
                    or any(x["device"] != "cuda" for x in lines):
                raise RuntimeError(f"launch.train ({name}): launches {launches}, losses "
                                   f"{losses}, lines {lines}")
            runs[name] = {"losses": losses, "lines": lines, "text": text}
        if "[ckpt] resumed at step 10" not in runs["resumed"]["text"]:
            raise RuntimeError(f"launch.train --resume: {runs['resumed']['text'][-500:]}")
        full, resumed = runs["uninterrupted"]["losses"][10:], runs["resumed"]["losses"]
        errs = [abs(a - b) / abs(b) for a, b in zip(resumed, full)]
        if max(errs) > TRAIN_CKPT_RTOL:
            raise RuntimeError(f"launch.train --resume: losses {resumed} vs {full}")
        out["launch_train"] = {"resumed_at": 10, "losses_resumed": resumed,
                               "losses_uninterrupted": full, "bit_identical": resumed == full,
                               "last_line": runs["resumed"]["lines"][-1],
                               "launches_per_step": per_step}
        t0 = time.perf_counter()
        example = runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                                 run_name="train_lm_torch")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            losses = example["main"](["--steps", "20", "--ckpt-dir", os.path.join(d, "example")])
        torch.cuda.synchronize()
        text = buf.getvalue()
        lines = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
        if len(losses) != 20 or not lines or lines[-1]["step"] != 20 \
                or lines[-1]["device"] != "cuda" or not losses[-1] < losses[0]:
            raise RuntimeError(f"examples/train_lm_torch.py: {text[-2000:]}")
        out["example"] = {"wall_s": time.perf_counter() - t0, "last_line": lines[-1],
                          "summary": text.strip().splitlines()[-1]}
    return out


def train_checkpoint_check(torch, dev, card: str) -> dict:
    """TRAIN_CKPT_ARCH at full width, cut to TRAIN_CKPT_LAYERS, under
    deterministic algorithms: TRAIN_STEPS steps with a CheckpointManager
    saving after step 2 (a background write beside step 3); the checkpoint
    restored into a fresh state (drawn from another seed) must give step
    3 of the uninterrupted run bit for bit (parameters, moments, step), or
    within TRAIN_CKPT_RTOL where an op refuses deterministic mode (named in
    the line).  Returns its line, with ``failures``."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.parallel import api as par
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(TRAIN_CKPT_ARCH), n_layers=TRAIN_CKPT_LAYERS)
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig())
    batches = train_batches(torch, cfg, dev)
    plan = {k: n for k, n in lm_launch_plan(cfg, 1).items() if n}
    failures, save_s = [], []
    with tempfile.TemporaryDirectory() as ckpt_dir, deterministic(torch) as refused:
        mgr = ckpt_mod.CheckpointManager(ckpt_dir, keep=1)

        def on_step(i, state):
            if i == 1:
                t0 = time.perf_counter()
                mgr.save_async(state, 2)
                save_s.append(time.perf_counter() - t0)

        state, steps, launches, _, _ = train_steps(torch, ops, step_mod, par, cfg, tcfg,
                                                   batches, dev, plain=False, on_step=on_step)
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        whole = host_copies(ckpt_mod, flat_tensors(state))
        del state
        torch.cuda.empty_cache()
        fresh = step_mod.make_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(1),
                                          device=dev)
        t0 = time.perf_counter()
        fresh, manifest = ckpt_mod.restore(ckpt_dir, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if int(manifest["step"]) != 2 or int(fresh.step) != 2:
            raise RuntimeError(f"{cfg.name}: restored step {manifest['step']}, {int(fresh.step)}")
        ops.reset_launch_counts()
        resumed, m3 = step_mod.build_train_step(cfg, tcfg, par.ParallelCtx())(fresh, batches[2])
        torch.cuda.synchronize()
        if {k: n for k, n in ops.launch_counts().items() if n} != plan:
            raise RuntimeError(f"{cfg.name}: the resumed step launched {ops.launch_counts()}")
        errs = leaf_errs(torch, ckpt_mod, flat_named(resumed), whole)
        exact = all(e["exact"] for e in errs)
        worst = max(e["rel_max"] for e in errs)
        if not refused() and not exact:
            failures.append(f"the resumed step 3 differs from the uninterrupted one under "
                            f"deterministic algorithms (max rel {worst})")
        if not worst <= TRAIN_CKPT_RTOL:
            failures.append(f"the resumed step 3 differs by {worst} relative")
        line = {"card": card, "arch": TRAIN_CKPT_ARCH, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "saved_after_step": 2, "bit_identical": exact,
                "max_rel_err": worst, "refused_deterministic": refused(),
                "losses": [x["loss"] for x in steps], "loss_step3_resumed": float(m3["loss"]),
                "launches": launches, "save_snapshot_s": save_s[0], "write_wait_s": wait_s,
                "restore_s": restore_s, "bytes": sum(a.nbytes for a, _ in whole),
                "leaves": len(whole), "failures": failures,
                "phase_s": time.perf_counter() - t_phase}
    log(f"checkpoint check: {line}")
    return line


def lm_train_phase(torch, dev, card: str) -> tuple[list, dict]:
    """The training phase (TRAIN_ARCHS, module docstring): one ``lm_train``
    line a model; raises after the last if any model failed a gate.
    Returns ([model lines], {kernel: {model: launches a step}})."""
    lines, per_step = [], {}
    for arch, (opt_name, layers) in TRAIN_ARCHS.items():
        line = train_model(torch, dev, card, arch, opt_name, layers)
        print(json.dumps({"lm_train": {arch: line}}), flush=True)
        lines.append(line)
        for k, n in line["launches_per_step"].items():
            per_step.setdefault(k, {})[arch] = n
    ckpt = train_checkpoint_check(torch, dev, card)
    print(json.dumps({"lm_train_checkpoint": ckpt}), flush=True)
    failed = {arch: line["failures"] for arch, line in zip(TRAIN_ARCHS, lines)
              if line["failures"]}
    if ckpt["failures"]:
        failed["checkpoint"] = ckpt["failures"]
    if failed:
        raise RuntimeError(f"lm_train: {failed}")
    return lines, per_step


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


def pct(xs, q: float) -> float:
    """The q-quantile of ``xs`` (linear between order statistics)."""
    xs = sorted(xs)
    i = q * (len(xs) - 1)
    lo = math.floor(i)
    return xs[lo] + (xs[min(lo + 1, len(xs) - 1)] - xs[lo]) * (i - lo)


def stream_probes(np, pts, eps, n: int, seed: int):
    """Query probes: half fitted points, three eighths within ±eps of one,
    one eighth outside the bounds."""
    rng = np.random.default_rng(seed)
    n_fit, n_near = n // 2, 3 * n // 8
    near = pts[rng.integers(0, len(pts), n_near)] + rng.uniform(-eps, eps, (n_near, 2))
    outside = rng.uniform(1.05, 1.5, (n - n_fit - n_near, 2))
    return np.concatenate([pts[rng.choice(len(pts), n_fit, replace=False)], near,
                           outside]).astype(np.float32)


def stream_state(svc) -> dict:
    """What two equal engines share: global labels, maps, the pair-d2
    cache and the dense local labels, copied to the host (on the CPU a
    bare ``.numpy()`` would alias tensors that later refreshes write in
    place).  The dist engine keeps labels per lane: stacked here."""
    out = {}
    for k in ("_glabels", "_maps", "_pair_d2", "_dense"):
        v = getattr(svc, k)
        out[k] = (svc.stacked(k) if isinstance(v, list) else v).to("cpu", copy=True).numpy()
    return out


def states_equal(np, a: dict, b: dict) -> bool:
    return all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def stream_reduced(torch, np, ddc, spatial, dev, eps: float, engine: str = "stream") -> dict:
    """The reduced stream run of check (f) on ``dev``: STREAM_SMALL's
    shards and capacity, make_d2 Morton-sorted (spatially compact shards),
    block-sparse DBSCAN in tiles of STREAM_SMALL_TILE on either device, a
    round-robin fit, then rounds of new points into shard r mod K, each
    refreshed and queried, through the ``engine`` ("stream" or "dist").
    Returns everything the two devices must agree on."""
    from repro_torch.serve import cluster_service as cs
    from repro_torch.serve import dist_service as ds

    k, cap, rounds, per = STREAM_SMALL
    pts = spatial.morton_sorted(spatial.make_d2(k * cap, seed=1))
    new = spatial.morton_sorted(spatial.make_d2(rounds * per, seed=DELTA_SEED))
    probes = stream_probes(np, pts, eps, STREAM_PROBES, 11)
    scfg = cs.StreamConfig(shards=k, capacity=cap, max_batch=STREAM_CHUNK,
                           ddc=ddc.DDCConfig(eps=eps, min_pts=4, block_sparse="always",
                                             block_tile=STREAM_SMALL_TILE))
    cls = ds.DistClusterService if engine == "dist" else cs.ClusterService
    svc = cls(scfg, meter=ddc.CommMeter(), device=dev)
    for shard, chunk in spatial.stream_batches(pts, k, STREAM_CHUNK):
        svc.ingest(shard, chunk, t=0.0)
    svc.refresh()
    out = {"states": [stream_state(svc)], "answers": [svc.query(probes).labels]}
    for r in range(rounds):
        svc.ingest(r % k, new[r * per:(r + 1) * per], t=float(r + 1))
        svc.refresh()
        out["states"].append(stream_state(svc))
        out["answers"].append(svc.query(probes).labels)
    out["meter"] = svc.meter.snapshot()
    out["state_dict"] = svc.state_dict()
    out["clusters"] = int(svc.global_set.valid.sum())
    return out


def reduced_diffs(np, a: dict, b: dict) -> list[str]:
    """Where two ``stream_reduced`` runs differ (empty when equal)."""
    (ca, cm), (pa, pm) = a["state_dict"], b["state_dict"]
    diffs = [f"refresh {i} {k}: {int((x[k] != y[k]).sum())}"
             for i, (x, y) in enumerate(zip(a["states"], b["states"]))
             for k in x if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k])]
    diffs += [f"answers {i}: {int((x != y).sum())}"
              for i, (x, y) in enumerate(zip(a["answers"], b["answers"]))
              if not np.array_equal(x, y)]
    diffs += [f"state_dict {k}" for k in sorted(set(ca) | set(pa))
              if k not in ca or k not in pa or ca[k].dtype != pa[k].dtype
              or not np.array_equal(ca[k], pa[k])]
    return diffs + ["meter"] * (a["meter"] != b["meter"]) + ["manifest"] * (cm != pm)


def stream_full_width(torch, np, ddc, ops, spatial, dev, eps, pts, card: str) -> dict:
    """The stream engine through the facade at full width (see the module
    docstring, phase 2's last item).  Returns its line."""
    from repro_torch import ddc as T
    from repro_torch.serve import cluster_service as cs
    from repro_torch.serve import faults
    from repro_torch.serve import query_tier as qt

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = T.DDCConfig(eps=eps, min_pts=4, backend="stream", shards=LANES,
                      max_batch=STREAM_CHUNK)
    model = T.DDC(cfg, meter=ddc.CommMeter(), device=dev)
    meter = model.backend.meter
    core = cfg.core()
    # The main path: the fit, the rounds and the forced full re-merge, the
    # launch counts zeroed just before each and read just after.
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(pts)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = ops.launch_counts()
    svc = model.service
    if svc.scfg.capacity != FULL_N // LANES:
        raise RuntimeError(f"stream: rings of {svc.scfg.capacity}, not {FULL_N // LANES}")
    fit_bytes = meter.snapshot()["bytes_total"]
    new = spatial.make_d2(FULL_N, seed=DELTA_SEED)
    parts = np.array_split(np.arange(FULL_N), LANES)
    probes = stream_probes(np, pts, eps, STREAM_PROBES, 9)
    ingest_ms, refresh_ms, query_ms, round_launches, round_bytes = [], [], [], [], []
    expiries = []
    totals = dict(fit_launches)
    clock = float(svc._next_seq)

    def ingest_round(r):
        """Round r's points, the next block of shard r mod 8's part of the
        second set, stamped with the fix clock (one tick a point)."""
        nonlocal clock
        shard = r % LANES
        block = new[parts[shard][(r // LANES) * STREAM_ROUND_N:][:STREAM_ROUND_N]]
        for off in range(0, STREAM_ROUND_N, STREAM_CHUNK):
            stamps = clock + np.arange(STREAM_CHUNK, dtype=np.float64)
            model.partial_fit(shard, block[off:off + STREAM_CHUNK], t=stamps)
            clock += STREAM_CHUNK

    def one_round(r):
        ops.reset_launch_counts()
        meter.reset()
        t0 = time.perf_counter()
        ingest_round(r)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        svc.refresh()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        model.query(probes)
        t3 = time.perf_counter()
        launches = ops.launch_counts()
        ingest_ms.append((t1 - t0) * 1e3)
        refresh_ms.append((t2 - t1) * 1e3)
        query_ms.append((t3 - t2) * 1e3)
        round_launches.append({k: v for k, v in launches.items() if v})
        round_bytes.append(meter.snapshot()["bytes_total"])
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    for r in range(STREAM_ROUNDS):
        one_round(r)
        if r % STREAM_TTL_EVERY == STREAM_TTL_EVERY - 1:
            cutoff = clock - STREAM_WINDOW
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            evicted = model.expire(cutoff)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n_dirty = len(svc._dirty)
            svc.refresh()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = ops.launch_counts()
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            expiries.append({"round": r, "t": cutoff, "evicted": evicted,
                             "dirty_shards": n_dirty, "expire_ms": (t1 - t0) * 1e3,
                             "refresh_ms": (t2 - t1) * 1e3,
                             "launches": {k: v for k, v in launches.items() if v}})
            if evicted < 1:
                raise RuntimeError(f"stream: the TTL expiry at round {r} evicted nothing")
    # (a) the patched matrix against B5's square rebuild of the final batch,
    # then the forced full re-merge (its launches join the main path's).
    d2_delta = svc.pair_d2
    labels_delta = svc._glabels.clone()
    ops.reset_launch_counts()
    meter.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.refresh(mode="full", force=True)
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    full_bytes = meter.snapshot()["bytes_total"]
    for k, v in ops.launch_counts().items():
        totals[k] = totals.get(k, 0) + v
    main_kernels = ("neighbor_count_sparse", "min_label_sweep_sparse", "contour_min_d2",
                    "cross_min_d2")
    if any(totals.get(k, 0) < 1 for k in main_kernels):
        raise RuntimeError(f"stream: a kernel of the stream path never launched: {totals}")
    # A one-shard round: one phase 1 (B3/B4, or B1/B2 where the lane's
    # tile pairs fall back to dense) and one rectangular B5 patch.
    if any(rl.get("cross_min_d2", 0) != 1 or "contour_min_d2" in rl
           or rl.get("neighbor_count_sparse", 0) + rl.get("neighbor_count", 0) != 1
           for rl in round_launches):
        raise RuntimeError(f"stream: a one-shard round did not run one phase 1 and one "
                           f"rectangular B5 patch: {round_launches}")
    b_bytes, c = core.buffer_bytes(), core.max_clusters
    want_delta, want_full = b_bytes + LANES * c * 4, LANES * b_bytes + LANES * c * 4
    if set(round_bytes) != {want_delta} or full_bytes != want_full:
        raise RuntimeError(f"stream: metered bytes {sorted(set(round_bytes))} / {full_bytes}, "
                           f"expected {want_delta} / {want_full}")
    square = ddc.contour_pair_d2(svc._batch, core)
    delta_equals_full = bool(torch.equal(d2_delta, square)) \
        and bool(torch.equal(svc._pair_d2, square)) and bool(torch.equal(svc._glabels,
                                                                         labels_delta))
    if not delta_equals_full:
        raise RuntimeError("stream: the delta-patched pair_d2 or labels differ from the full "
                           "re-merge's")
    # (b) the batch path over the final rings.
    dense, sets = [], []
    for i in range(LANES):
        d, cs_i = ddc.local_phase(svc._pts[i], svc._mask[i], core)
        dense.append(d)
        sets.append(cs_i)
    _, maps_b = ddc.merge_many(ddc.stack_clustersets(sets), core)
    labels_b = cs._global_labels(torch.stack(dense), torch.stack(svc._mask), maps_b)
    matches_batch = bool(torch.equal(labels_b, svc._glabels))
    if not matches_batch:
        raise RuntimeError("stream: the streamed global labels differ from the batch path's")
    # One more round's refresh under the profiler: its device time against
    # the rounds' median refresh.
    ingest_round(STREAM_ROUNDS)
    prof = profile_fn(torch, svc.refresh, pct(refresh_ms, 0.5) / 1e3, top=8,
                      require=("neighbor_count_sparse_sym_kernel", "min_label_sparse_sym_kernel"))
    # (c) the query tier over the published snapshot against the sync query.
    sync = model.query(probes)
    tier = model.query_tier
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for part in np.array_split(probes, 8):
        tier.submit(part)
    drained = tier.drain()
    tier_s = time.perf_counter() - t0
    tier_labels = np.concatenate([r.labels for r in drained])
    snapshot_matches_sync = bool(np.array_equal(tier_labels, sync.labels))
    if not snapshot_matches_sync or drained[0].version != sync.version:
        raise RuntimeError("stream: the tier's answers differ from the sync query's")
    # (d) state_dict -> from_state on the card, then one more round on both.
    arrays, manifest = svc.state_dict()
    twin = cs.ClusterService.from_state(svc.scfg, arrays, manifest, device=dev)
    restore_same = states_equal(np, stream_state(twin), stream_state(svc))
    shard = (STREAM_ROUNDS + 1) % LANES
    more = new[parts[shard][-STREAM_ROUND_N:]]
    for e in (svc, twin):
        e.ingest(shard, more)
        e.refresh()
    restore_bitexact = restore_same and states_equal(np, stream_state(twin), stream_state(svc))
    if not restore_bitexact:
        raise RuntimeError("stream: the restored engine differs from the original")
    # (e) shard 3's delta dropped beyond max_retries: quarantine, routed
    # queries, recovery, then the fault-free twin's state.
    attempts = svc.scfg.max_retries + 2
    svc.faults = faults.FaultPlan(events=(faults.FaultEvent(
        "drop", shard=STREAM_FAULT_SHARD, delivery=None, attempts=attempts),))
    more = new[parts[STREAM_FAULT_SHARD][-2 * STREAM_ROUND_N:-STREAM_ROUND_N]]
    for e in (svc, twin):
        e.ingest(STREAM_FAULT_SHARD, more)
        e.refresh()
    near3 = svc._hpts[STREAM_FAULT_SHARD][svc._live[STREAM_FAULT_SHARD]][:64]
    routed = model.query(near3)
    quarantined = dict(svc.quarantined)
    svc.faults = None                       # the link heals; the shard rejoins
    recovered = svc.recover(STREAM_FAULT_SHARD)
    svc.refresh()
    drill = {"quarantined": list(quarantined) == [STREAM_FAULT_SHARD],
             "routed_around": routed.degraded and STREAM_FAULT_SHARD not in routed.scanned_shards,
             "recovered": recovered and not svc.quarantined,
             "state_equal": states_equal(np, stream_state(twin), stream_state(svc)),
             "answers_equal": bool(np.array_equal(model.query(probes).labels,
                                                  twin.query(probes).labels))}
    recovered_bitexact = all(drill.values())
    if not recovered_bitexact:
        raise RuntimeError(f"stream: the fault drill failed: {drill}, quarantined "
                           f"{quarantined}, routed {routed!r}")
    peak = torch.cuda.max_memory_allocated(dev)
    n_clusters = int(svc.global_set.valid.sum())
    del twin
    # (f) the reduced run, on the card and on the CPU.
    eps_small = eps * STREAM_SMALL_EPS
    t0 = time.perf_counter()
    small_card = stream_reduced(torch, np, ddc, spatial, dev, eps_small)
    t1 = time.perf_counter()
    small_cpu = stream_reduced(torch, np, ddc, spatial, "cpu", eps_small)
    t2 = time.perf_counter()
    diffs = reduced_diffs(np, small_card, small_cpu)
    card_equals_cpu = not diffs
    if not card_equals_cpu:
        raise RuntimeError(f"stream: the reduced run on the card differs from the CPU's: "
                           f"{diffs[:20]}")
    sync_probes_per_s = STREAM_PROBES / (pct(query_ms, 0.5) / 1e3)
    return {
        "card": card, "n": FULL_N, "shards": LANES, "capacity": svc.scfg.capacity,
        "eps": eps, "min_pts": 4, "max_batch": STREAM_CHUNK, "rounds": STREAM_ROUNDS,
        "round_points": STREAM_ROUND_N, "probes": STREAM_PROBES, "fit_s": fit_s,
        "fit_bytes": fit_bytes, "fit_launches": {k: v for k, v in fit_launches.items() if v},
        "ingest_ms": {"p50": pct(ingest_ms, 0.5), "p99": pct(ingest_ms, 0.99)},
        "refresh_ms": {"p50": pct(refresh_ms, 0.5), "p99": pct(refresh_ms, 0.99),
                       "max": max(refresh_ms)},
        "query_ms": {"p50": pct(query_ms, 0.5), "p99": pct(query_ms, 0.99)},
        "full_remerge_ms": full_ms, "delta_bytes": round_bytes[0], "full_bytes": full_bytes,
        "bytes_ratio": full_bytes / round_bytes[0],
        "sync_probes_per_s": sync_probes_per_s, "tier_probes_per_s": STREAM_PROBES / tier_s,
        "tier_launches": tier.query_launches,
        "launches_per_round": round_launches[0], "launches_per_round_all_equal":
            all(rl == round_launches[0] for rl in round_launches),
        "b4_launches_per_round": [rl.get("min_label_sweep_sparse", 0) for rl in round_launches],
        "main_path_launches": {k: v for k, v in totals.items() if v},
        "expiries": expiries, "profile_refresh": prof, "peak_bytes": peak,
        "n_clusters": n_clusters, "n_live": svc.n_live(),
        "checks": {"delta_equals_full": delta_equals_full, "matches_batch": matches_batch,
                   "snapshot_matches_sync": snapshot_matches_sync,
                   "restore_bitexact": restore_bitexact,
                   "recovered_bitexact": recovered_bitexact,
                   "card_equals_cpu": card_equals_cpu},
        "reduced": {"shards": STREAM_SMALL[0], "capacity": STREAM_SMALL[1],
                    "rounds": STREAM_SMALL[2], "round_points": STREAM_SMALL[3],
                    "eps": eps_small, "block_tile": STREAM_SMALL_TILE,
                    "clusters": small_card["clusters"],
                    "card_s": t1 - t0, "cpu_s": t2 - t1},
        "phase_s": time.perf_counter() - t_phase}


def stream_overlap(torch, fn, wall_s: float) -> dict:
    """Kernels by CUDA stream over one call of ``fn`` under torch.profiler,
    read from its Chrome trace: how many ran, on how many streams, how
    many overlapped in time a kernel on another stream, their summed and
    their union device time, and the union's share of ``wall_s`` (the
    same work's unprofiled wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    ks = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 (e.get("args") or {}).get("stream", e.get("tid")))
                for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    if not ks:
        return {"kernels": 0, "device_ms": "not measured", "wall_s": wall_s}
    overlapped, active = set(), []
    for i, (t0, t1, st) in enumerate(ks):
        active = [a for a in active if a[0] > t0]
        for end, st2, j in active:
            if st2 != st:
                overlapped.update((i, j))
        active.append((t1, st, i))
    union, lo, hi = 0.0, ks[0][0], ks[0][1]
    for t0, t1, _ in ks[1:]:
        if t0 > hi:
            union += hi - lo
            lo, hi = t0, t1
        else:
            hi = max(hi, t1)
    union += hi - lo
    return {"kernels": len(ks), "streams": len({st for *_, st in ks}),
            "overlapped_kernels": len(overlapped),
            "device_ms_sum": sum(t1 - t0 for t0, t1, _ in ks) / 1e3,
            "device_ms_union": union / 1e3, "wall_s": wall_s,
            "busy_share": union / 1e6 / wall_s}


def bench_serve_row(torch, np, ddc, spatial, name: str, spec: dict, k: int, backend: str,
                    dev) -> dict:
    """One row of BENCH_serve.json through the port on ``dev``:
    benchmarks/serve.py's ``bench_cell`` sequence (round-robin ingest with
    a refresh after every batch, a one-point delta refresh then three
    timed, a full re-merge then three timed, a query warm-up then three
    timed, the tier's ``SERVE_BENCH_QPS`` requests of 32 points in bursts
    of 8, each answer held to the sync query), its hardware-free fields."""
    from repro_torch import ddc as T
    from repro_torch.parallel import compress
    from repro_torch.serve import query_tier as qt

    pts = spec["make"](SERVE_BENCH_N)
    cap = spatial.shard_capacity(SERVE_BENCH_N, k)
    batch = min(256, cap)
    cfg = T.DDCConfig(eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
                      max_clusters=spec["max_clusters"], max_verts=spec["max_verts"],
                      backend=backend, shards=k, capacity=cap, max_batch=batch,
                      max_queries=256).validate()
    meter = ddc.CommMeter()
    model = T.DDC(cfg, meter=meter, device=dev)
    svc = model.service
    for shard, chunk in spatial.stream_batches(pts, k, batch):
        model.partial_fit(shard, chunk)
        svc.refresh()
    meter.reset()
    model.partial_fit(0, pts[:1])
    svc.refresh()
    delta_bytes = meter.snapshot()["bytes_total"]
    for _ in range(3):
        model.partial_fit(0, pts[:1])
        svc.refresh()
    d2_delta = svc.pair_d2.cpu().numpy()
    meter.reset()
    svc.remerge_full()
    full_bytes = meter.snapshot()["bytes_total"]
    d2_full = svc.pair_d2.cpu().numpy()
    for _ in range(3):
        svc.remerge_full()
    q = np.random.default_rng(0).uniform(0, 1, (256, 2)).astype(np.float32)
    for _ in range(4):
        model.query(q)
    routing = svc.routing_stats()
    tier = qt.QueryTier(svc, max_queries=256, max_staleness=float("inf"))
    svc.read_snapshot()
    rng = np.random.default_rng(1)
    req = [rng.uniform(0, 1, (32, 2)).astype(np.float32) for _ in range(SERVE_BENCH_QPS)]
    tier.query(req[0])
    handles = []
    for off in range(0, SERVE_BENCH_QPS, 8):
        burst = [tier.submit(p) for p in req[off:off + 8]]
        tier.drain()
        handles.extend(burst)
    matches = all(np.array_equal(np.asarray(h.result), svc.query(p, legacy=True))
                  for p, h in zip(req, handles))
    live, parts, labels = svc.live()
    host, _, _ = ddc.ddc_host(live, len(parts), spec["eps"], spec["min_pts"], partition=parts,
                              contour="grid")
    return {"backend": backend, "layout": name, "shards": k, "n_live": int(len(live)),
            "delta_bytes": delta_bytes, "full_bytes": full_bytes,
            "delta_bytes_int8": compress.pytree_wire_bytes_int8(svc.local_set(0))
            + k * cfg.max_clusters * 4,
            "buffer_bytes": cfg.core().buffer_bytes(),
            "d2_pairs_delta": cfg.max_clusters * k * cfg.max_clusters,
            "d2_pairs_full": (k * cfg.max_clusters) ** 2,
            "query_shards_scanned": routing["query_shards_scanned"],
            "query_shards_possible": routing["query_shards_possible"],
            "n_clusters": int(svc.global_set.valid.sum()),
            "matches_host": ddc.same_clustering(labels, host),
            "delta_equals_full": bool(np.array_equal(d2_delta, d2_full)),
            "snapshot_matches_sync": bool(matches)}


def bench_serve(torch, np, ddc, spatial, dev) -> dict:
    """BENCH_serve.json's 32 rows on ``dev``: every hardware-free field
    equal to the file's, and each dist row's bytes within its stream
    row's (``dist_axis_bytes_le_stream_delta``)."""
    bench = json.loads((ROOT / "BENCH_serve.json").read_text())
    t0 = time.perf_counter()
    rows, bad = [], []
    for want in bench["rows"]:
        name = want["layout"]
        got = bench_serve_row(torch, np, ddc, spatial, name, spatial.PHASE2_LAYOUTS[name],
                              want["shards"], want["backend"], dev)
        diff = [f for f in SERVE_BENCH_FIELDS if got[f] != want[f]]
        if diff:
            bad.append({"row": [want["backend"], name, want["shards"]],
                        "fields": {f: [got[f], want[f]] for f in diff}})
        rows.append(got)
    stream_delta = {(r["layout"], r["shards"]): r["delta_bytes"]
                    for r in rows if r["backend"] == "stream"}
    le = all(r["delta_bytes"] <= stream_delta[(r["layout"], r["shards"])]
             for r in rows if r["backend"] == "dist")
    if bad or not le or le != bench["summary"]["dist_axis_bytes_le_stream_delta"]:
        raise RuntimeError(f"BENCH_serve.json: the card's rows differ: {bad[:6]}, "
                           f"dist_axis_bytes_le_stream_delta {le}")
    return {"rows": len(rows), "fields": list(SERVE_BENCH_FIELDS), "all_equal": True,
            "dist_axis_bytes_le_stream_delta": le, "qps_requests": SERVE_BENCH_QPS,
            "s": time.perf_counter() - t0}


def serve_cli_runs(np, dev) -> dict:
    """``python -m repro_torch.launch.serve`` on the card: ``--mode ddc``
    and ``--mode track`` with ``--backend dist``, each beside the same
    flags on ``--backend stream`` (run side by side); every line parses
    and its hardware-free fields equal the stream run's."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = {}
    for mode, flags in (("ddc", ["--shards", str(LANES)]), ("track", [])):
        procs = {b: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode", mode, "--backend", b,
             "--device", str(dev), *flags], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for b in ("dist", "stream")}
        lines = {}
        for b, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            if p.returncode != 0:
                raise RuntimeError(f"launch.serve --mode {mode} --backend {b} exited "
                                   f"{p.returncode}: {stderr[-2000:]}")
            lines[b] = json.loads(stdout.strip().splitlines()[-1])
        d, st = lines["dist"], lines["stream"]
        keys = sorted(set(d) - SERVE_TIMING_FIELDS - {"backend"})
        diff = [k for k in keys if d[k] != st.get(k)]
        if diff or set(d) != set(st):
            raise RuntimeError(f"launch.serve --mode {mode}: dist differs from stream in "
                               f"{diff}: {[d.get(k) for k in diff]} vs "
                               f"{[st.get(k) for k in diff]}")
        out[mode] = {"dist": {k: d[k] for k in sorted(d) if k != "tracks"},
                     "stream_timing": {k: st[k] for k in sorted(st) if k in SERVE_TIMING_FIELDS},
                     "fields_equal": keys}
    return out


def dist_full_width(torch, np, ddc, ops, spatial, dev, eps, pts, card: str) -> dict:
    """The dist engine through the facade at full width, beside its stream
    twin in the same call (see the module docstring).  Returns its line."""
    from repro_torch import ddc as T
    from repro_torch.serve import cluster_service as cs
    from repro_torch.serve import dist_service as ds
    from repro_torch.serve import faults

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kw = dict(eps=eps, min_pts=4, shards=LANES, max_batch=STREAM_CHUNK)
    names = ("dist", "stream")
    models = {b: T.DDC(T.DDCConfig(backend=b, **kw), meter=ddc.CommMeter(), device=dev)
              for b in names}
    core = models["dist"].config.core()
    b_bytes, c = core.buffer_bytes(), core.max_clusters
    want_delta, want_full = b_bytes + LANES * c * 4, LANES * b_bytes + LANES * c * 4
    rec = {b: {"ingest_ms": [], "refresh_ms": [], "query_ms": [], "expiry_refresh_ms": [],
               "bytes": []} for b in names}
    totals: dict = {}
    round_launches = []
    compared = [0]

    def add(launches):
        for key, v in launches.items():
            totals[key] = totals.get(key, 0) + v

    def compare(what: str):
        a, b = (stream_state(models[n].service) for n in names)
        if not states_equal(np, a, b):
            bad = [key for key in a if not np.array_equal(a[key], b[key])]
            raise RuntimeError(f"dist: differs from stream after {what} in {bad}")
        compared[0] += 1

    # The main path: dist's fit, rounds, expiries and full re-merge, the
    # launch counts zeroed just before each and read just after; the
    # stream twin runs after each, outside the counts.
    fit_s = {}
    for b in names:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        models[b].fit(pts)
        torch.cuda.synchronize()
        fit_s[b] = time.perf_counter() - t0
        if b == "dist":
            fit_launches = ops.launch_counts()
            add(fit_launches)
    compare("the fit")
    svcs = {b: models[b].service for b in names}
    lanes = svcs["dist"].lanes
    streams = {lane.stream.cuda_stream for lane in lanes}
    if len(streams) != LANES or torch.cuda.current_stream(dev).cuda_stream in streams \
            or svcs["dist"].scfg.capacity != FULL_N // LANES:
        raise RuntimeError(f"dist: {len(streams)} lane streams for {LANES} lanes, capacity "
                           f"{svcs['dist'].scfg.capacity}")
    new = spatial.make_d2(FULL_N, seed=DELTA_SEED)
    parts = np.array_split(np.arange(FULL_N), LANES)
    probes = stream_probes(np, pts, eps, STREAM_PROBES, 9)
    clock = {b: float(svcs[b]._next_seq) for b in names}
    expiries = []

    def ingest_round(b, r):
        shard = r % LANES
        block = new[parts[shard][(r // LANES) * STREAM_ROUND_N:][:STREAM_ROUND_N]]
        for off in range(0, STREAM_ROUND_N, STREAM_CHUNK):
            stamps = clock[b] + np.arange(STREAM_CHUNK, dtype=np.float64)
            models[b].partial_fit(shard, block[off:off + STREAM_CHUNK], t=stamps)
            clock[b] += STREAM_CHUNK

    def expire(b, advance: float = 0.0):
        """A TTL expiry and its refresh (every shard dirty); its ms."""
        evicted = models[b].expire(clock[b] + advance - STREAM_WINDOW)
        dirty = len(svcs[b]._dirty)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svcs[b].refresh()
        torch.cuda.synchronize()
        return evicted, dirty, (time.perf_counter() - t0) * 1e3

    for r in range(STREAM_ROUNDS):
        answers = {}
        for b in names:
            m, svc = models[b], svcs[b]
            ops.reset_launch_counts()
            m.backend.meter.reset()
            t0 = time.perf_counter()
            ingest_round(b, r)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            svc.refresh()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            answers[b] = m.query(probes).labels
            t3 = time.perf_counter()
            if b == "dist":
                launches = ops.launch_counts()
                add(launches)
                round_launches.append({key: v for key, v in launches.items() if v})
            rec[b]["ingest_ms"].append((t1 - t0) * 1e3)
            rec[b]["refresh_ms"].append((t2 - t1) * 1e3)
            rec[b]["query_ms"].append((t3 - t2) * 1e3)
            rec[b]["bytes"].append(m.backend.meter.snapshot()["bytes_total"])
        compare(f"round {r}")
        if not np.array_equal(answers["dist"], answers["stream"]):
            raise RuntimeError(f"dist: the sync answers differ from stream's in round {r}")
        if r % STREAM_TTL_EVERY == STREAM_TTL_EVERY - 1:
            row = {"round": r}
            for b in names:
                ops.reset_launch_counts()
                evicted, dirty, ms = expire(b)
                if b == "dist":
                    launches = ops.launch_counts()
                    add(launches)
                    row.update(evicted=evicted, dirty_shards=dirty, refresh_ms=ms,
                               launches={key: v for key, v in launches.items() if v})
                else:
                    row["stream_refresh_ms"] = ms
                rec[b]["expiry_refresh_ms"].append(ms)
            if row["dirty_shards"] != LANES:
                raise RuntimeError(f"dist: the expiry at round {r} dirtied {row['dirty_shards']} "
                                   f"shards, not {LANES}")
            expiries.append(row)
            compare(f"the expiry at round {r}")
    full_ms = {}
    for b in names:
        ops.reset_launch_counts()
        models[b].backend.meter.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svcs[b].refresh(mode="full", force=True)
        torch.cuda.synchronize()
        full_ms[b] = (time.perf_counter() - t0) * 1e3
        if b == "dist":
            add(ops.launch_counts())
    compare("the full re-merge")
    full_bytes = models["dist"].backend.meter.snapshot()["bytes_total"]
    if any(totals.get(key, 0) < 1 for key in DIST_PATH_KERNELS):
        raise RuntimeError(f"dist: a kernel of the dist path never launched: {totals}")
    if any(rl.get("cross_min_d2", 0) != 1 or "contour_min_d2" in rl
           or rl.get("neighbor_count_sparse", 0) + rl.get("neighbor_count", 0) != 1
           for rl in round_launches):
        raise RuntimeError(f"dist: a one-shard round did not run one phase 1 and one "
                           f"rectangular B5 patch: {round_launches}")
    if set(rec["dist"]["bytes"]) != {want_delta} or full_bytes != want_full \
            or set(rec["stream"]["bytes"]) != {want_delta}:
        raise RuntimeError(f"dist: metered bytes {sorted(set(rec['dist']['bytes']))} / "
                           f"{full_bytes}, expected {want_delta} / {want_full}")
    # One more 8-dirty refresh (the TTL window advanced by 8,192 fix
    # stamps) under the profiler: kernels on distinct lane streams.
    for b in names:
        models[b].expire(clock[b] + 8192 - STREAM_WINDOW)
    dirty_profiled = len(svcs["dist"]._dirty)
    overlap = stream_overlap(torch, svcs["dist"].refresh,
                             pct(rec["dist"]["expiry_refresh_ms"], 0.5) / 1e3)
    svcs["stream"].refresh()
    compare("the profiled expiry")
    # state_dict -> from_state across the engines, then one more round on
    # all four engines.
    (da, dm), (sa, sm) = svcs["dist"].state_dict(), svcs["stream"].state_dict()
    if dm != sm or sorted(da) != sorted(sa) or \
            any(da[key].dtype != sa[key].dtype or not np.array_equal(da[key], sa[key])
                for key in da):
        raise RuntimeError("dist: state_dict differs from the stream engine's")
    from_dist = cs.ClusterService.from_state(svcs["stream"].scfg, da, dm, device=dev)
    from_stream = ds.DistClusterService.from_state(svcs["dist"].scfg, sa, sm, device=dev)
    restored_same = states_equal(np, stream_state(from_dist), stream_state(svcs["dist"])) \
        and states_equal(np, stream_state(from_stream), stream_state(svcs["stream"]))
    shard = (STREAM_ROUNDS + 1) % LANES
    more = new[parts[shard][-STREAM_ROUND_N:]]
    four = (svcs["dist"], svcs["stream"], from_dist, from_stream)
    for e in four:
        e.ingest(shard, more)
        e.refresh()
    ref_state = stream_state(svcs["dist"])
    restore_crosses = restored_same and all(states_equal(np, stream_state(e), ref_state)
                                            for e in four[1:])
    if not restore_crosses:
        raise RuntimeError("dist: a state restored across the engines differs")
    del from_dist, from_stream, four
    # Shard 3's delta dropped beyond max_retries on both engines:
    # quarantine, routed queries, recovery.
    attempts = svcs["dist"].scfg.max_retries + 2
    more = new[parts[STREAM_FAULT_SHARD][-2 * STREAM_ROUND_N:-STREAM_ROUND_N]]
    routed = {}
    for b in names:
        svc = svcs[b]
        svc.faults = faults.FaultPlan(events=(faults.FaultEvent(
            "drop", shard=STREAM_FAULT_SHARD, delivery=None, attempts=attempts),))
        svc.ingest(STREAM_FAULT_SHARD, more)
        svc.refresh()
        near = svc._hpts[STREAM_FAULT_SHARD][svc._live[STREAM_FAULT_SHARD]][:64]
        routed[b] = (dict(svc.quarantined), models[b].query(near))
    compare("the dropped delta")
    (dq, dr), (sq, sr) = routed["dist"], routed["stream"]
    drill = {"quarantined": list(dq) == [STREAM_FAULT_SHARD] and dq == sq,
             "routed_around": dr.degraded and STREAM_FAULT_SHARD not in dr.scanned_shards
             and (dr.degraded, dr.scanned_shards) == (sr.degraded, sr.scanned_shards)
             and bool(np.array_equal(dr.labels, sr.labels))}
    for b in names:
        svcs[b].faults = None
        drill[f"recovered_{b}"] = svcs[b].recover(STREAM_FAULT_SHARD)
        svcs[b].refresh()
    compare("the recovery")
    drill["answers_equal"] = bool(np.array_equal(models["dist"].query(probes).labels,
                                                 models["stream"].query(probes).labels))
    if not all(drill.values()):
        raise RuntimeError(f"dist: the fault drill differs from stream's: {drill}")
    peak = torch.cuda.max_memory_allocated(dev)
    n_clusters = int(svcs["dist"].global_set.valid.sum())
    del models, svcs
    torch.cuda.empty_cache()
    # The tree of degree DIST_TREE_DEGREE at DIST_TREE_SHARDS lanes against
    # flat dist at the same lanes (UNCUT, Morton-sorted blocks).
    k16, per = DIST_TREE_SHARDS, FULL_N // DIST_TREE_SHARDS
    tpts = spatial.morton_sorted(spatial.make_d2(FULL_N, seed=1))
    tnew = spatial.morton_sorted(spatial.make_d2(FULL_N, seed=DELTA_SEED))
    core_u = ddc.DDCConfig(**UNCUT)
    tree_svcs = {deg: ds.DistClusterService(cs.StreamConfig(
        shards=k16, capacity=per, max_batch=DIST_TREE_ROUND_N, agg_degree=deg, ddc=core_u),
        meter=ddc.CommMeter(), device=dev) for deg in (None, DIST_TREE_DEGREE)}
    biggest, tree_ms = 0, {"flat": [], "tree": []}

    def tree_refresh(what):
        nonlocal biggest
        for deg, svc in tree_svcs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.refresh()
            torch.cuda.synchronize()
            tree_ms["flat" if deg is None else "tree"].append((time.perf_counter() - t0) * 1e3)
            biggest = max(biggest, largest_count(svc))
        flat, tree = tree_svcs[None], tree_svcs[DIST_TREE_DEGREE]
        if biggest >= core_u.max_verts:
            raise RuntimeError(f"dist tree: a contour fills max_verts ({biggest})")
        if not (torch.equal(tree.stacked("_glabels"), flat.stacked("_glabels"))
                and torch.equal(tree._maps, flat._maps) and tree.pair_d2 is None):
            raise RuntimeError(f"dist tree: degree {DIST_TREE_DEGREE} differs from flat dist "
                               f"after {what}")

    for svc in tree_svcs.values():
        for s_ in range(k16):
            svc.ingest(s_, tpts[s_ * per:(s_ + 1) * per], t=np.arange(per, dtype=np.float64))
    tree_refresh("the fit")
    for r in range(DIST_TREE_ROUNDS):
        s_ = (r * 5) % k16
        block = tnew[s_ * per:s_ * per + DIST_TREE_ROUND_N]
        for svc in tree_svcs.values():
            svc.ingest(s_, block, t=float(per + r))
        tree_refresh(f"round {r}")
    tree_clusters = int(tree_svcs[None].global_set.valid.sum())
    tree_bytes = {("flat" if deg is None else "tree"): svc.meter.snapshot()["bytes_total"]
                  for deg, svc in tree_svcs.items()}
    del tree_svcs
    torch.cuda.empty_cache()
    # The reduced run through dist, on the card and on the CPU.
    eps_small = eps * STREAM_SMALL_EPS
    t0 = time.perf_counter()
    small_card = stream_reduced(torch, np, ddc, spatial, dev, eps_small, engine="dist")
    t1 = time.perf_counter()
    small_cpu = stream_reduced(torch, np, ddc, spatial, "cpu", eps_small, engine="dist")
    t2 = time.perf_counter()
    diffs = reduced_diffs(np, small_card, small_cpu)
    if diffs:
        raise RuntimeError(f"dist: the reduced run on the card differs from the CPU's: "
                           f"{diffs[:20]}")
    bench = bench_serve(torch, np, ddc, spatial, dev)
    cli = serve_cli_runs(np, dev)

    def ms(b, key):
        xs = rec[b][key]
        return {"p50": pct(xs, 0.5), "p99": pct(xs, 0.99), "max": max(xs)}

    families = [kernel_families(rl) for rl in round_launches]
    return {
        "card": card, "n": FULL_N, "shards": LANES, "lane_streams": len(streams),
        "capacity": FULL_N // LANES, "eps": eps, "min_pts": 4, "max_batch": STREAM_CHUNK,
        "rounds": STREAM_ROUNDS, "round_points": STREAM_ROUND_N, "probes": STREAM_PROBES,
        "fit_s": fit_s, "fit_launches": {key: v for key, v in fit_launches.items() if v},
        **{f"{key}_ms": {b: ms(b, f"{key}_ms") for b in names}
           for key in ("ingest", "refresh", "query", "expiry_refresh")},
        "full_remerge_ms": full_ms, "delta_bytes": want_delta, "full_bytes": full_bytes,
        "buffer_bytes": b_bytes, "launches_per_round": round_launches[0],
        "b3_b4_b5_per_round": {"b3": sorted({f["b3"] for f in families}),
                               "b4": [f["b4"] for f in families],
                               "b5_rect": sorted({f["b5_rect"] for f in families})},
        "main_path_launches": {key: v for key, v in totals.items() if v},
        "expiries": expiries, "refreshes_compared": compared[0],
        "profile_8_dirty": {"dirty_shards": dirty_profiled, **overlap},
        "peak_bytes": peak, "n_clusters": n_clusters,
        "tree": {"shards": k16, "degree": DIST_TREE_DEGREE, "rounds": DIST_TREE_ROUNDS,
                 "clusters": tree_clusters, "largest_contour": biggest,
                 "refresh_ms_p50": {key: pct(v, 0.5) for key, v in tree_ms.items()},
                 "bytes": tree_bytes, "equals_flat": True},
        "reduced": {"shards": STREAM_SMALL[0], "capacity": STREAM_SMALL[1],
                    "rounds": STREAM_SMALL[2], "round_points": STREAM_SMALL[3],
                    "clusters": small_card["clusters"], "card_s": t1 - t0, "cpu_s": t2 - t1},
        "bench_serve": bench, "serve_cli": cli,
        "checks": {"equals_stream_every_refresh": True, "answers_equal_every_round": True,
                   "bytes_exact": True, "restore_crosses_engines": restore_crosses,
                   "fault_drill_equals_stream": True, "tree_equals_flat": True,
                   "card_equals_cpu": True, "bench_serve_equal": True,
                   "serve_cli_equal": True},
        "phase_s": time.perf_counter() - t_phase}


def bench_hierarchy_points(np, seed: int):
    """benchmarks/hierarchy.py's blob layout (8 Gaussian clusters)."""
    rng = np.random.default_rng(seed)
    centers = [(0.18 + 0.32 * (i % 3), 0.18 + 0.32 * (i // 3)) for i in range(BENCH_HIER_BLOBS)]
    per = BENCH_HIER_N // BENCH_HIER_BLOBS
    pts = np.concatenate([c + rng.normal(scale=0.018, size=(per, 2)) for c in centers])
    return np.clip(pts, 0.01, 0.99).astype(np.float32)


def bench_hierarchy_batches(torch, np, ddc, k: int, dev):
    """benchmarks/hierarchy.py's shard batch at ``k`` shards (contiguous
    partition, one ``local_phase`` a shard) and its churn variant (shard 0
    from the seed-1 layout)."""
    cfg = ddc.DDCConfig(**BENCH_HIER_CFG)

    def sets(pts, only=None):
        slices = np.array_split(pts, k)
        cap = max(len(s) for s in slices)
        out = []
        for sl in slices[:only]:
            buf = np.zeros((cap, 2), np.float32)
            buf[:len(sl)] = sl
            mask = np.zeros((cap,), bool)
            mask[:len(sl)] = True
            out.append(ddc.local_phase(torch.from_numpy(buf).to(dev),
                                       torch.from_numpy(mask).to(dev), cfg)[1])
        return out

    batch = ddc.stack_clustersets(sets(bench_hierarchy_points(np, 0)))
    alt0 = sets(bench_hierarchy_points(np, 1), only=1)[0]
    batch_alt = ddc.ClusterSet(*(b.clone() for b in batch))
    for b, a in zip(batch_alt, alt0):
        b[0] = a
    return cfg, batch, batch_alt


def bench_hierarchy_row(torch, ddc, hierarchy, cfg, batch, batch_alt, k: int, degree: int,
                        dev) -> dict:
    """One row of BENCH_hierarchy.json, its hardware-free fields: the
    refresh sequence of benchmarks/hierarchy.py (the cold build, steady
    one-dirty refreshes of shard 0, churn toggles of shard 0 between the
    two batches, a last steady refresh) through the flat fold and the
    port's ``AggregatorTree``.  The benchmark's timing loops repeat
    refreshes that leave the state as they found it, so one pass of each
    gives its stats."""
    bbytes, row = cfg.buffer_bytes(), cfg.max_clusters * 4
    merged, maps, d2 = ddc.merge_delta(batch, None, None, cfg, None)
    for b in (batch, batch_alt, batch):
        merged, maps, d2 = ddc.merge_delta(b, d2, [0], cfg, None)
    tree = hierarchy.AggregatorTree(k, degree, cfg, device=dev)
    tree.refresh(batch, None, None)
    for _ in range(3):
        tree.refresh(batch, [0], None)
    steady = dict(tree.last_stats)
    for b in (batch_alt, batch, batch_alt, batch):
        tree.refresh(b, [0], None)
    churn = dict(tree.last_stats)
    g, tmaps = tree.refresh(batch, [0], None)

    def wire(stats):
        return (stats["up_shard_payloads"] * bbytes + stats["internal_up_edges"] * bbytes
                + stats["down_internal_edges"] * row + stats["down_shard_rows"] * row)

    return {
        "depth": tree.depth, "n_nodes": tree.n_nodes, "n_clusters": int(merged.valid.sum()),
        "flat_refresh_bytes": bbytes + k * row, "hier_refresh_bytes": wire(steady),
        "flat_churn_bytes": bbytes + k * row, "hier_churn_bytes": wire(churn),
        "flat_bottleneck_bytes": bbytes + k * row,
        "hier_bottleneck_bytes": steady["bottleneck_bytes"],
        "buffer_bytes": bbytes, "absorbed_steady": steady["absorbed"],
        "maps_match": bool(torch.equal(tmaps, maps)),
        "valid_match": bool(torch.equal(g.valid, merged.valid)),
        "sizes_match": bool(torch.equal(g.sizes, merged.sizes)),
        "root_d2_exact": tree.cache_exact(),
        "overflow": bool(merged.overflow | g.overflow),
    }


def largest_count(svc) -> int:
    """The most vertices any contour of ``svc`` holds: its local
    (per-shard) contours, its global set and, in tree mode, every node
    summary."""
    counts = [svc._batch.counts.max(), svc.global_set.counts.max()]
    if svc.hierarchy is not None:
        counts += [n.summary.counts.max() for level in svc.hierarchy.levels for n in level
                   if n.summary is not None]
    return int(max(int(c) for c in counts))


DIST_PATH_KERNELS = ("neighbor_count_sparse", "min_label_sweep_sparse", "contour_min_d2",
                     "cross_min_d2")
B5_RECT = ("cross_min_d2",)
B5_SQUARE = ("contour_min_d2",)
B4 = ("min_label_sweep_sparse", "min_label_sweep")
B3 = ("neighbor_count_sparse", "neighbor_count")


def kernel_families(launches: dict) -> dict:
    """Launch counts by kernel family: B3 (the counts), B4 (the sweeps),
    B5 in its rectangular and square forms (dense and sparse forms of the
    pair kernels summed)."""
    return {name: sum(launches.get(k, 0) for k in keys)
            for name, keys in (("b3", B3), ("b4", B4), ("b5_rect", B5_RECT),
                               ("b5_square", B5_SQUARE))}


def hierarchy_full_width(torch, np, ddc, ops, spatial, dev, card: str):
    """The tree of aggregators at full width (see the module docstring).
    Returns its line and, for the kernels line, a tree-of-degree-2 leaf's
    B5 rectangular inputs at each degree."""
    from repro_torch.serve import cluster_service as cs
    from repro_torch.serve import hierarchy

    t_phase = time.perf_counter()
    k, per = HIER_SHARDS, HIER_SHARD_N
    pts = spatial.morton_sorted(spatial.make_d2(k * per, seed=1))
    new = spatial.morton_sorted(spatial.make_d2(k * per, seed=DELTA_SEED))
    core = ddc.DDCConfig(**UNCUT)
    topo = {"flat": None, **{f"tree{d}": d for d in HIER_DEGREES}}
    svcs = {name: cs.ClusterService(
        cs.StreamConfig(shards=k, capacity=per, max_batch=HIER_ROUND_N, agg_degree=deg,
                        ddc=core), meter=ddc.CommMeter(), device=dev)
        for name, deg in topo.items()}
    rec = {name: {"refresh_ms": [], "launches": {"fit": {}, "round": {}, "expiry": {}},
                  "bytes": [], "folds": [], "absorbed": [], "bottleneck_bytes": [],
                  "expiry_refresh_ms": []} for name in svcs}
    biggest = [0]

    def refresh_all(kind: str):
        """Refresh each service (launch counts zeroed just before and read
        just after each), then hold both trees to the flat engine."""
        for name, svc in svcs.items():
            r = rec[name]
            ops.reset_launch_counts()
            svc.meter.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.refresh()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = r["launches"][kind]
            for key, v in ops.launch_counts().items():
                got[key] = got.get(key, 0) + v
            if kind == "round":
                r["refresh_ms"].append(ms)
                r["bytes"].append(svc.meter.snapshot()["bytes_total"])
                if svc.hierarchy is not None:
                    st = svc.hierarchy.last_stats
                    r["folds"].append(st["folds"])
                    r["absorbed"].append(st["absorbed"])
                    r["bottleneck_bytes"].append(st["bottleneck_bytes"])
            elif kind == "expiry":
                r["expiry_refresh_ms"].append(ms)
            else:
                r["fit_refresh_ms"] = ms
            biggest[0] = max(biggest[0], largest_count(svc))
        if biggest[0] >= core.max_verts:
            raise RuntimeError(f"hierarchy: a contour fills max_verts ({biggest[0]}): tree "
                               f"== flat is not promised there")
        flat = svcs["flat"]
        for name, svc in svcs.items():
            if svc is flat:
                continue
            same_all = (torch.equal(svc._glabels, flat._glabels)
                        and torch.equal(svc._maps, flat._maps)
                        and torch.equal(svc.global_set.valid, flat.global_set.valid)
                        and torch.equal(svc.global_set.sizes, flat.global_set.sizes))
            if not same_all or svc.pair_d2 is not None:
                raise RuntimeError(f"hierarchy: {name} differs from the flat aggregator after "
                                   f"a {kind} refresh")

    t0 = time.perf_counter()
    for svc in svcs.values():
        for s in range(k):
            svc.ingest(s, pts[s * per:(s + 1) * per], t=np.arange(per, dtype=np.float64))
    refresh_all("fit")
    fit_s = time.perf_counter() - t0
    n_clusters = int(svcs["flat"].global_set.valid.sum())
    if n_clusters < UNCUT_MIN_CLUSTERS or bool(svcs["flat"].global_set.overflow):
        raise RuntimeError(f"hierarchy: {n_clusters} global clusters (overflow "
                           f"{bool(svcs['flat'].global_set.overflow)}); the phase needs at "
                           f"least {UNCUT_MIN_CLUSTERS} and no overflow")
    evicted = []
    for r in range(HIER_ROUNDS + 1):
        s = (r * 4) % k
        block = new[s * per:(s + 1) * per][(r // (k // 4)) * HIER_ROUND_N:][:HIER_ROUND_N]
        for svc in svcs.values():
            svc.ingest(s, block, t=float(per + r))
        if r == HIER_ROUNDS:
            break                                   # the profiled round below
        refresh_all("round")
        if r % HIER_TTL_EVERY == HIER_TTL_EVERY - 1:
            cutoff = float(HIER_TTL_STEP * (r // HIER_TTL_EVERY + 1))
            got = [sum(svc.evict_older_than(i, cutoff) for i in range(k))
                   for svc in svcs.values()]
            if len(set(got)) != 1 or got[0] < 1:
                raise RuntimeError(f"hierarchy: the TTL expiry at round {r} evicted {got}")
            evicted.append(got[0])
            refresh_all("expiry")
    trees = {name: svc.hierarchy for name, svc in svcs.items() if svc.hierarchy is not None}
    if not all(t.cache_exact() for t in trees.values()):
        raise RuntimeError("hierarchy: a node cache differs from its rebuild")
    # One more round's refresh of each service under the profiler (the
    # last ingest above), against its rounds' median refresh.
    profiles = {}
    for name, svc in svcs.items():
        profiles[name] = profile_fn(torch, svc.refresh, pct(rec[name]["refresh_ms"], 0.5) / 1e3,
                                    top=6)
    if not (torch.equal(svcs["tree2"]._glabels, svcs["flat"]._glabels)
            and torch.equal(svcs["tree4"]._maps, svcs["flat"]._maps)):
        raise RuntimeError("hierarchy: the profiled round differs from flat")
    out = {"card": card, "n": k * per, "shards": k, "capacity": per, "config": UNCUT,
           "max_clusters": core.max_clusters, "rounds": HIER_ROUNDS,
           "round_points": HIER_ROUND_N, "ttl_evicted": evicted, "fit_s": fit_s,
           "n_clusters": n_clusters, "largest_count": biggest[0],
           "max_verts": core.max_verts, "tree_equals_flat_every_refresh": True,
           "cache_exact": True, "topologies": {}}
    for name, svc in svcs.items():
        r = rec[name]
        fam = {kind: kernel_families(v) for kind, v in r["launches"].items()}
        total = {f: sum(fam[kind][f] for kind in fam) for f in fam["fit"]}
        if total["b5_rect"] < 1 or total["b5_square"] < 1 or total["b3"] < 1 or total["b4"] < 1:
            raise RuntimeError(f"hierarchy: a kernel of {name}'s path never launched: "
                               f"{r['launches']}")
        entry = {"refresh_ms": {"p50": pct(r["refresh_ms"], 0.5),
                                "p99": pct(r["refresh_ms"], 0.99)},
                 "fit_refresh_ms": r["fit_refresh_ms"],
                 "expiry_refresh_ms": r["expiry_refresh_ms"],
                 "metered_bytes_per_refresh": statistics.mean(r["bytes"]),
                 "launches": {"fit": fam["fit"], "rounds": fam["round"],
                              "expiries": fam["expiry"], "total": total},
                 "profile_refresh": profiles[name]}
        if svc.hierarchy is not None:
            entry |= {"degree": svc.hierarchy.degree, "depth": svc.hierarchy.depth,
                      "n_nodes": svc.hierarchy.n_nodes,
                      "folds_per_round": statistics.mean(r["folds"]),
                      "absorbed_per_round": statistics.mean(r["absorbed"]),
                      "bottleneck_bytes_per_round": statistics.mean(r["bottleneck_bytes"])}
        out["topologies"][name] = entry
    # BENCH_hierarchy.json's rows on the card.
    t0 = time.perf_counter()
    bench = json.loads((ROOT / "BENCH_hierarchy.json").read_text())
    rows = {}
    for kb in bench["shards"]:
        cfg_b, batch, batch_alt = bench_hierarchy_batches(torch, np, ddc, kb, dev)
        for deg in bench["degrees"]:
            want = next(w for w in bench["rows"] if (w["shards"], w["degree"]) == (kb, deg))
            got = bench_hierarchy_row(torch, ddc, hierarchy, cfg_b, batch, batch_alt, kb, deg,
                                      dev)
            diff = {f: (got[f], want[f]) for f in BENCH_HIER_FIELDS if got[f] != want[f]}
            if diff:
                raise RuntimeError(f"hierarchy: BENCH_hierarchy.json row k={kb} d={deg} "
                                   f"differs: {diff}")
            rows[f"k{kb}_d{deg}"] = {f: got[f] for f in ("hier_refresh_bytes",
                                                         "hier_bottleneck_bytes",
                                                         "absorbed_steady")}
    out["bench_rows"] = {"rows": len(rows), "equal_to_json": True, "s": time.perf_counter() - t0,
                         "fields": list(BENCH_HIER_FIELDS), "by_row": rows}
    # B5's rectangular form at a node fold's shape: a leaf's first child's
    # C rows against the leaf's D·C slots.
    c, v = core.max_clusters, core.max_verts
    shapes = {}
    for name, tree in trees.items():
        b = tree.levels[0][0].batch
        conts = b.contours.reshape(-1, v, 2).contiguous()
        cnts = b.counts.reshape(-1).contiguous()
        vals = b.valid.reshape(-1).contiguous()
        shapes[f"degree_{tree.degree}"] = (conts[:c].contiguous(), cnts[:c].contiguous(),
                                           vals[:c].contiguous(), conts, cnts, vals)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, shapes


def tracker_states_equal(np, a, b) -> bool:
    """Two ``ClusterTracker.state_dict()`` results: the manifests and every
    array (dtype included)."""
    (aa, am), (ba, bm) = a, b
    return am == bm and set(aa) == set(ba) and all(
        aa[k].dtype == ba[k].dtype and np.array_equal(aa[k], ba[k]) for k in aa)


def tracking_full_width(torch, np, ddc, ops, spatial, dev, card: str):
    """Cluster tracking at full width (see the module docstring).  Returns
    its line and the tracker's B5 rectangular inputs (previous × current
    generation's slots) for the kernels line."""
    from repro_torch import ddc as T
    from repro_torch.serve import tracking

    t_phase = time.perf_counter()
    traj = spatial.make_drifting_blobs(steps=TRACK_STEPS, n_per_step=TRACK_FRAME_N,
                                       n_blobs=TRACK_BLOBS, radius=0.02, speed=0.01, seed=0)
    cap = spatial.trajectory_capacity(TRACK_FRAME_N, TRACK_WINDOW, TRACK_SHARDS)

    def model(agg=None):
        cfg = T.DDCConfig(**TRACK_CFG, backend="stream", shards=TRACK_SHARDS, capacity=cap,
                          max_batch=cap // (TRACK_WINDOW + 1), agg_degree=agg,
                          track=True).validate()
        return T.DDC(cfg, device=dev)

    def timed(m, gens: list):
        """Time each refresh of ``m``'s engine and count its launches
        (zeroed just before, read just after)."""
        svc = m.service
        inner = svc.refresh

        def refresh(*a, **kw):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            gens.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "launches": kernel_families(ops.launch_counts()),
                         "update_ms": svc.tracker.last_update_ms})
            return out

        svc.refresh = refresh
        return m

    def play_steps(m, frames, start=0):
        """tracking.play's loop from frame ``start`` on."""
        for i, frame in enumerate(frames):
            step = start + i
            for shard, part in enumerate(np.array_split(frame, TRACK_SHARDS)):
                m.partial_fit(shard, part, t=float(step) * np.ones(len(part)))
            if step + 1 > TRACK_WINDOW:
                m.expire(float(step - TRACK_WINDOW + 1))
            m.service.refresh()

    runs = {}
    for name, agg in (("flat", None), ("tree2", 2)):
        gens = []
        m = timed(model(agg), gens)
        t0 = time.perf_counter()
        snap = tracking.play(m, traj.frames, window=TRACK_WINDOW)
        runs[name] = {"model": m, "snap": snap, "gens": gens, "s": time.perf_counter() - t0,
                      "state": m.service.tracker.state_dict()}
    flat = runs["flat"]
    if not tracker_states_equal(np, flat["state"], runs["tree2"]["state"]):
        raise RuntimeError("tracking: the tree's tracker state differs from the flat engine's")
    # Save at TRACK_RESUME_AT, load on the card, resume.
    part1 = model()
    play_steps(part1, traj.frames[:TRACK_RESUME_AT])
    at_resume = part1.service.tracker.state_dict()
    with tempfile.TemporaryDirectory() as d:
        part1.save(os.path.join(d, "snap"))
        resumed = T.DDC.load(os.path.join(d, "snap"), device=dev)
        play_steps(resumed, traj.frames[TRACK_RESUME_AT:], TRACK_RESUME_AT)
    resumed_bitexact = tracker_states_equal(np, flat["state"],
                                            resumed.service.tracker.state_dict())
    if not resumed_bitexact:
        raise RuntimeError("tracking: save -> load -> resume differs from the uninterrupted run")
    # The plain versions of the kernels on the first TRACK_RESUME_AT frames
    # (every generation), against the kernel run saved there (all
    # TRACK_STEPS frames took 52–60 s on an H100; cut to make room for the
    # lm_mesh phase).
    plain = model()
    t0 = time.perf_counter()
    ops.FORCE = "ref"
    try:
        play_steps(plain, traj.frames[:TRACK_RESUME_AT])
    finally:
        ops.FORCE = None
    plain_s = time.perf_counter() - t0
    plain_bitexact = tracker_states_equal(np, at_resume, plain.service.tracker.state_dict())
    if not plain_bitexact:
        raise RuntimeError("tracking: the plain run's tracker state differs from the kernels'")
    # The ground truth: eight lanes that never meet.
    snap = flat["snap"]
    late = sum(1 for e in snap.events if e.kind == "birth" and e.gen > 1)
    churn = late + snap.deaths + snap.merges + snap.splits
    id_stability = 1.0 if snap.continuations + churn == 0 else \
        snap.continuations / (snap.continuations + churn)
    v_err = []
    for t in snap.alive:
        b = int(np.argmin(((traj.centers[t.last_gen - 1] - t.centroid) ** 2).sum(1)))
        g1, g0 = t.last_gen, t.last_gen - (t.hits - 1)
        true_v = (traj.centers[g1 - 1, b] - traj.centers[g0 - 1, b]) / (g1 - g0)
        v_err.append(float(max(abs(t.velocity[0] - true_v[0]), abs(t.velocity[1] - true_v[1]))))
    truth = {"births": snap.births, "deaths": snap.deaths, "merges": snap.merges,
             "splits": snap.splits, "id_stability": id_stability, "alive": len(snap.alive),
             "velocity_max_err": max(v_err, default=None)}
    if (snap.births, snap.deaths, snap.merges, snap.splits, len(snap.alive)) != \
            (TRACK_BLOBS, 0, 0, 0, TRACK_BLOBS) or id_stability != 1.0 \
            or not all(e < TRACK_V_TOL for e in v_err):
        raise RuntimeError(f"tracking: the events or velocities miss the ground truth: {truth}")
    # The tracker's B5 rectangular inputs and its _global_d2 at 256 × 256.
    tracker = flat["model"].service.tracker
    prev = tracker._prev
    pc, pn, pg = tracker._prev_dev
    b5_in = (pc, pn, pg >= 0, pc, pn, pg >= 0)
    global_d2_ms = median_ms(torch, lambda: tracker._global_d2(prev, tracker._prev_dev,
                                                               prev["gmap"], prev["slots"]), 10)
    out = {"card": card, "steps": TRACK_STEPS, "frame_points": TRACK_FRAME_N,
           "blobs": TRACK_BLOBS, "shards": TRACK_SHARDS, "window": TRACK_WINDOW,
           "capacity": cap, "live_points": flat["model"].service.n_live(),
           "config": TRACK_CFG, "max_verts": TRACK_CFG["max_verts"],
           "largest_count": largest_count(flat["model"].service),
           "slots": [int(pc.shape[0]), int(pc.shape[0])], "truth": truth,
           "checks": {"tree_equals_flat": True, "resumed_bitexact": resumed_bitexact,
                      "resumed_at": TRACK_RESUME_AT, "plain_bitexact": plain_bitexact,
                      "plain_generations": TRACK_RESUME_AT, "plain_s": plain_s},
           "global_d2_ms": global_d2_ms, "runs": {}}
    for name, run in runs.items():
        gens = run["gens"]
        rect = [g["launches"]["b5_rect"] for g in gens]
        if sum(rect) < 1:
            raise RuntimeError(f"tracking: B5's rectangular form never launched ({name})")
        upd = [g["update_ms"] for g in gens]
        out["runs"][name] = {
            "play_s": run["s"], "refresh_ms_p50": pct([g["ms"] for g in gens], 0.5),
            "update_ms_mean": statistics.mean(upd[2:]), "update_ms_last": upd[-1],
            "b5_rect_per_generation": rect, "launches_last_generation": gens[-1]["launches"],
            "launches_total": {f: sum(g["launches"][f] for g in gens) for f in gens[0]["launches"]}}
    if out["largest_count"] >= TRACK_CFG["max_verts"]:
        raise RuntimeError(f"tracking: a contour fills max_verts ({out['largest_count']})")
    out["phase_s"] = time.perf_counter() - t_phase
    return out, b5_in


RANKS_SCHEDULES = ("sync", "async", "tree")
RANKS_INIT_SEED = 5
RANKS_KERNELS = ("neighbor_count_sparse", "min_label_sweep_sparse", "contour_min_d2",
                 "pairwise_dist_sq")


def outputs_equal(np, ddc, res, one) -> list[str]:
    """Names of what differs between a ranks run (``RanksResult``) and the
    one-process run's (glabels, gcs, maps): labels, maps, and every leaf of
    every rank's global ClusterSet."""
    glabels, gcs, maps = (ddc.host_copy(one[0]), [ddc.host_copy(t) for t in one[1]],
                          ddc.host_copy(one[2]))
    bad = [n for n, a, b in (("glabels", res.glabels, glabels), ("maps", res.maps, maps))
           if a.dtype != b.dtype or not np.array_equal(a, b)]
    bad += [f"rank{r}.gcs.{f}" for r, rec in enumerate(res.ranks)
            for f, a, b in zip(ddc.ClusterSet._fields, rec["gcs"], gcs)
            if a.dtype != b.dtype or not np.array_equal(a, b)]
    return bad


def ranks_full_width(torch, np, ddc, ops, dev, eps, pts, card: str) -> tuple[dict, dict]:
    """DDC across 8 rank processes on the one card (``launch/ranks.py``,
    gloo, ``ddc_shard``) on phase 2's full-width set, under sync, async
    and tree and with K-Means ranks fed their initial centres: each equal
    to the one-process ``make_ddc_fn`` run bit for bit, meters and the
    ranks' gloo bytes equal, every rank launching B3, B4 and B5.  Returns
    (its line, the ranks' launches by kernel and run)."""
    from repro_torch.launch import ranks

    t_phase = time.perf_counter()
    mask = np.ones(FULL_N, bool)
    base = ddc.DDCConfig(eps=eps, min_pts=4)
    cfg_km = dataclasses.replace(base, local_algo="kmeans", schedule="async")
    per = FULL_N // LANES
    rng = np.random.default_rng(RANKS_INIT_SEED)
    k_cent = min(cfg_km.kmeans_k, cfg_km.max_clusters)
    init = np.stack([pts[i * per + rng.choice(per, k_cent, replace=False)]
                     for i in range(LANES)]).astype(np.float32)
    jobs = {s: dict(cfg=dataclasses.replace(base, schedule=s)) for s in RANKS_SCHEDULES}
    jobs["kmeans"] = dict(cfg=cfg_km, init=init)
    timing: dict = {}
    t0 = time.perf_counter()
    results = ranks.run_ddc_cases(
        [dict(points=pts, mask=mask, k=LANES, warmup=1, profile=True, **job)
         for job in jobs.values()], LANES, device=dev.type, timing=timing, timeout=600)
    spawn_call_s = time.perf_counter() - t0
    out = {"card": card, "n": FULL_N, "ranks": LANES, "backend": timing["backend"], "eps": eps,
           "start_up": timing, "spawn_call_s": spawn_call_s, "runs": {}}
    launches: dict = {}
    for (name, job), res in zip(jobs.items(), results):
        cfg = job["cfg"]
        meter = ddc.CommMeter()
        run = ddc.make_ddc_fn(cfg, LANES, device=dev, meter=meter, init=job.get("init"))
        run(pts, mask)                                    # warm-up
        torch.cuda.synchronize()
        meter.reset()
        trace: dict = {}
        one = run(pts, mask, trace)
        torch.cuda.synchronize()
        bad = outputs_equal(np, ddc, res, one)
        if bad:
            raise RuntimeError(f"ranks {name}: differs from the one-process run in {bad}")
        if res.meter != meter.snapshot() or res.sent_bytes != meter.bytes_total:
            raise RuntimeError(f"ranks {name}: meter {res.meter}, gloo bytes {res.sent_bytes}, "
                               f"one process {meter.snapshot()}")
        per_rank = [rec["launches"] for rec in res.ranks]
        want = ("pairwise_dist_sq",) if name == "kmeans" else RANKS_KERNELS[:2]
        for r, (got, rec) in enumerate(zip(per_rank, res.ranks)):
            if any(got.get(k, 0) < 1 for k in want) \
                    or got.get("contour_min_d2", 0) != rec["merge_calls"]:
                raise RuntimeError(f"ranks {name}: rank {r} launched {got} in "
                                   f"{rec['merge_calls']} merges")
        for k in RANKS_KERNELS:
            launches.setdefault(k, {})[name] = [got.get(k, 0) for got in per_rank]
        device_ms = [rec.get("device_ms") for rec in res.ranks]
        wall = res.phase1_s + res.phase2_s
        out["runs"][name] = {
            "phase1_s": res.phase1_s, "phase2_s": res.phase2_s,
            "rank_phase1_s": [rec["phase1_s"] for rec in res.ranks],
            "rank_phase2_s": [rec["phase2_s"] for rec in res.ranks],
            "one_process_phase1_s": trace["phase1_s"],
            "one_process_phase2_s": trace["phase2_s"],
            "rank_device_ms": device_ms,
            "busy_share": (sum(device_ms) / 1e3 / wall
                           if all(isinstance(d, float) for d in device_ms) else "not measured"),
            "merge_calls": [rec["merge_calls"] for rec in res.ranks],
            "sent_bytes": [rec["sent_bytes"] for rec in res.ranks], "meter": res.meter,
            "launches": per_rank, "n_clusters": int(res.gcs.valid.sum()),
            "bit_identical_to_one_process": True}
    if not all(sum(launches["contour_min_d2"][s][r] for s in RANKS_SCHEDULES) >= 1
               for r in range(LANES)):
        raise RuntimeError(f"ranks: a rank never launched B5: {launches['contour_min_d2']}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches


def curation_phase(torch, np, ddc, ops, dev, card: str) -> dict:
    """``repro_torch.data.curation`` on the card: the example's corpus on 8
    lanes equal to the same call on the CPU and to the host path's
    clustering; then CURATION_N documents on 8 lanes equal to the same
    run under ``ops.FORCE = "ref"`` (halved until no cluster budget
    overflows)."""
    from repro_torch.data import curation, pipeline
    from repro_torch.launch import mesh as mesh_mod

    sys.path.insert(0, str(ROOT / "examples"))
    import data_curation_torch as example

    t_phase = time.perf_counter()
    fields = ("labels", "n_clusters", "cluster_sizes", "sample_weights", "exchanged_fraction")

    def differ(a, b) -> list[str]:
        return [f for f in fields if not np.array_equal(np.asarray(getattr(a, f)),
                                                        np.asarray(getattr(b, f)))]

    _, emb, _ = example.corpus()
    t0 = time.perf_counter()
    card_res = curation.curate(emb, mesh=mesh_mod.make_lane_mesh(LANES, dev))
    card_s = time.perf_counter() - t0
    cpu_res = curation.curate(emb, mesh=mesh_mod.make_lane_mesh(LANES, "cpu"))
    host_res = curation.curate(emb)
    if differ(card_res, cpu_res):
        raise RuntimeError(f"curation: card differs from the CPU in {differ(card_res, cpu_res)}")
    if not ddc.same_clustering(host_res.labels, card_res.labels) \
            or sorted(host_res.cluster_sizes) != sorted(card_res.cluster_sizes):
        raise RuntimeError("curation: the host path's clustering differs from the lanes'")
    n = CURATION_N
    dcfg = pipeline.DataConfig(vocab=4096, seq_len=64, global_batch=64, n_latent_clusters=8,
                               seed=0)
    cfg = curation.DEFAULT_CONFIG
    while True:
        docs, _ = pipeline.doc_embeddings(dcfg, n)
        _, gcs, _ = ddc.make_ddc_fn(cfg, LANES, device=dev)(docs, np.ones(n, bool))
        if not bool(gcs.overflow) or n <= 2048:
            break
        n //= 2
    lanes = mesh_mod.make_lane_mesh(LANES, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    big = curation.curate(docs, mesh=lanes)
    big_s = time.perf_counter() - t0
    big_launches = {k: v for k, v in ops.launch_counts().items() if v}
    ops.FORCE = "ref"
    try:
        t0 = time.perf_counter()
        plain = curation.curate(docs, mesh=lanes,
                                cfg=dataclasses.replace(cfg, block_sparse="always"))
        plain_s = time.perf_counter() - t0
    finally:
        ops.FORCE = None
    if differ(big, plain):
        raise RuntimeError(f"curation at {n} documents: kernels differ from the plain run in "
                           f"{differ(big, plain)}")
    for k in RANKS_KERNELS[:3]:
        if big_launches.get(k, 0) < 1:
            raise RuntimeError(f"curation at {n} documents launched {big_launches}")
    return {"card": card, "example": {
                "docs": len(emb), "lanes": LANES, "n_clusters": card_res.n_clusters,
                "cluster_sizes": card_res.cluster_sizes.astype(int).tolist(),
                "exchanged_fraction": card_res.exchanged_fraction, "card_s": card_s,
                "card_equals_cpu": True, "host_path_same_clustering": True,
                "host_exchanged_fraction": host_res.exchanged_fraction},
            "full": {"docs": n, "cut_from": CURATION_N, "overflow": bool(gcs.overflow),
                     "n_clusters": big.n_clusters, "exchanged_fraction": big.exchanged_fraction,
                     "s": big_s, "plain_s": plain_s, "launches": big_launches,
                     "bit_identical_to_plain": True},
            "phase_s": time.perf_counter() - t_phase}


def dryrun_phase(torch, ops, ref, dev, card: str) -> tuple[dict, dict]:
    """``repro_torch.launch.dryrun_ddc`` at DRYRUN_POINTS points: 256 and
    512 lanes × sync, tree and async on the card, each meter equal to its
    closed form (``run_cell`` raises otherwise), the 512-lane sync / async
    wire ratio 511/9.  Returns (its line, B5 at the 512-lane sync fold's
    shape, whose slot lists take the staged entries, against its plain
    version)."""
    from repro_torch.data import spatial
    from repro_torch.kernels import contour_dist
    from repro_torch.launch import dryrun_ddc

    t_phase = time.perf_counter()
    pts = spatial.make_d2(DRYRUN_POINTS)
    cells, batch = [], None
    for k in dryrun_ddc.LANES:
        for s in dryrun_ddc.SCHEDULES:
            trace: dict = {}
            cells.append(dryrun_ddc.run_cell(k, s, pts, device=dev, trace=trace))
            if k == 512 and s == "sync":
                batch = trace["batch"]
            del trace
            torch.cuda.empty_cache()
    # B5's staged entry (a compaction launch, then the main kernel) runs in
    # the 512-lane sync fold and nowhere else.
    for cell in cells:
        staged_cell = cell["cell"] == "ddc_spatial_512lanes_sync"
        if cell["compact_launches"] != int(staged_cell) or (
                staged_cell and cell["launches"].get("contour_min_d2") != 1):
            raise RuntimeError(f"dryrun_ddc: {cell['cell']}: B5 launches {cell['launches']}, "
                               f"compactions {cell['compact_launches']}")
    ratio = dryrun_ddc.sync_async_ratio(cells, 512)
    if abs(ratio["sync_async_wire_ratio"] - 511 / 9) > 5e-5:
        raise RuntimeError(f"dryrun_ddc: sync/async wire ratio {ratio}")
    line = {"card": card, "points": DRYRUN_POINTS, "cells": cells, "ratio": ratio,
            "meters_closed_form": True}
    # B5 at the 512-lane fold: 32,768 slots, past a block's shared memory.
    m, v = batch.valid.numel(), batch.contours.shape[-2]
    conts = batch.contours.reshape(m, v, 2).contiguous()
    cnts = batch.counts.reshape(m).contiguous()
    valids = batch.valid.reshape(m).contiguous()
    if contour_dist._staged(v, m, conts.device) is None:
        raise RuntimeError(f"dryrun_ddc: {m} slots fit shared memory; no staged launch")
    kern = lambda: ops.contour_min_d2(conts, cnts, valids)  # noqa: E731
    plain = lambda: ref.contour_min_d2(conts, cnts, valids)  # noqa: E731
    before = (ops.launch_counts()["contour_min_d2"],
              contour_dist.compact_launches["contour_min_d2"])
    if not same(torch, kern(), plain()):
        raise RuntimeError("dryrun_ddc: B5's staged launch differs from its plain version")
    a_call = {"main": ops.launch_counts()["contour_min_d2"] - before[0],
              "compact": contour_dist.compact_launches["contour_min_d2"] - before[1]}
    if a_call != {"main": 1, "compact": 1}:
        raise RuntimeError(f"dryrun_ddc: B5's staged call launched {a_call}")
    extra = contour_extra(torch, "contour_min_d2", cnts, valids, v, kern)
    b_ms, b_by = bound(extra["bound_tests"] * CMD2_OPS_PER_PAIR,
                       extra["valid_vertices"] * 8 + m * (4 + 1) + m * m * 4)
    staged = {"shape": [m, v], "staged_lists": True, "exact": True,
              "launches_a_call": a_call, **extra,
              "ms": median_ms(torch, kern, 5, per=4), "plain_ms": median_ms(torch, plain, 2),
              "bound_ms": b_ms, "bound_by": b_by}
    line["b5_at_512_lane_fold"] = staged
    del batch, conts
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t_phase
    return line, staged


def shape_timing(torch, ops, ref, args, floor_ms: float) -> dict:
    """B5's rectangular form on ``args`` against its plain version (bit for
    bit), its device time and the plain one's, beside the launch floor."""
    got, want = ops.cross_min_d2(*args), ref.cross_min_d2(*args)
    if not same(torch, got, want):
        raise RuntimeError("cross_min_d2: the kernel differs from its plain version at "
                           f"{list(got.shape)}")
    return {"shape": [int(args[0].shape[0]), int(args[3].shape[0]), int(args[0].shape[1])],
            "exact": True, "ms": median_ms(torch, lambda: ops.cross_min_d2(*args), 20, per=10),
            "plain_ms": median_ms(torch, lambda: ref.cross_min_d2(*args), 3),
            "floor_ms": floor_ms}


# -- LM over a mesh of ranks (lm_mesh) ----------------------------------------
# The LM stack's explicit SPMD over rank processes that share this card
# (launch/ranks.py; gloo, each collective staged through pinned host
# memory: NCCL refuses two ranks on one card).  Each case is held to the
# one-rank port run on the same parameters (the same seeded draw, cut by
# spec on each rank) and inputs, which rank 0 computes first while the
# others wait; its results sit on rank 0's host and reach each rank's
# shard by a gloo scatter.  Cuts, each by the 80 GB the four ranks share:
# - qwen3-8b at full width, 2 of 36 layers (float32 params, m, v and grads
#   of 2.4 B params are 38 GB whole on rank 0's one-rank run);
# - llama4-scout at full width, 1 of 48 layers (every layer MoE: the
#   leaves are 17 GB in float32, 8 GB of them experts);
# - the llama4 Adafactor steps at 2 × 1,024 tokens, not 4 × 2,048, and
#   with FSDP: the one-rank step holds 17 GB of params, 17 of grads, up to
#   four float32 copies of its largest leaf (4.1 GB) in the update and the
#   activations; each of the four ranks about 18 GB of shards, gathers,
#   grads and activations.
# The MoE runs at llama4-scout's published capacity factor, 1.25, so its
# routes drop token-copies, each by its own rule: epsum ranks a copy among
# its data lane's copies to the same expert (the one-rank route run on
# each data lane's part of the batch); the a2a island among its lane's
# copies to the same destination lane (⌈t·k/D·cf⌉ send slots), then among
# the copies an expert receives (⌈D·cap/(E/D)⌉); its replicated branch
# among all copies to an expert (⌈t·k/(E/D)⌉, no capacity factor).  Each
# one-rank reference runs the "local" route at capacity factor E (it
# drops nothing) with the mesh route's drops applied (``moe_mesh_keep``,
# ``masked_routes``), so it is exact, and the drop rules themselves are
# held to the reference's own mesh runs in tests/test_torch_mesh.py.
MESH_SHAPE = (2, 2)
MESH_AXES = ("data", "model")
MESH_SEED = 0
MESH_QWEN = ("qwen3-8b", 2, (2, 2048))            # arch, layers, (batch, seq)
MESH_LLAMA = ("llama4-scout-17b-a16e", 1, (4, 2048), (2, 1024))
# lr 1e-3 from the first step (warmup 1): the update is the whole lr.
MESH_OPT = dict(lr=1e-3, warmup=1)
# Tolerances against the one-rank run, each set from the readings of
# tools/mesh_phase.py --control (PERF.md) with room for rounding:
# - losses rtol MESH_LOSS_RTOL (read ≤ 2.2e-7), MESH_INT8_LOSS_RTOL under
#   the int8 wire (read 6.3e-5); gradient norms rtol MESH_GNORM_RTOL (read
#   ≤ 1.3e-5, the int8 wire's);
# - each leaf's update, ‖Δmesh − Δone rank‖ / ‖Δone rank‖ over the whole
#   leaf (through its sketch, below), at most MESH_UPDATE_RTOL[kind]: "exact" steps read ≤ 5.9e-4
#   (AdamW's first update divides each gradient by its own magnitude, so
#   an element whose gradient rounds to the other side of 0 flips),
#   "compress" (compress_grads: an element at an int8 rounding midpoint
#   moves a step) 3.5e-3, "int8" (the a2a wire's rounding, up to 1/254 of
#   a row's absmax, flips the sign-like update of small gradients in a
#   norm weight) 0.17.  A zero update reads 1, a sign-flipped one 2, and
#   the one-rank update of data lane 0's half of the batch 1.10 (qwen3)
#   and 1.30 (llama4);
# - the final hidden states MESH_HIDDEN_TOL (rtol, atol) without the
#   int8 wire (read 3.2e-5 abs), and with it RMS(mesh − one rank) <=
#   MESH_INT8_RMS × RMS(one rank) (read 1.4 %; the reference's own
#   int8-wire MoE output is 1.0 % RMS from its plain a2a one at
#   tests/_torch_ref_script.py's tiny llama4-scout).
MESH_LOSS_RTOL = 1e-5
MESH_INT8_LOSS_RTOL = 5e-4
MESH_GNORM_RTOL = 1e-4
MESH_UPDATE_RTOL = {"exact": 5e-3, "compress": 2e-2, "int8": 0.3}
MESH_HIDDEN_TOL = (1e-4, 1e-4)
MESH_INT8_RMS = 3e-2
MESH_SERVE = ("qwen3-8b", 2, 2)                   # arch, layers, --mesh-devices
# The layers computed on their shards (Mamba-2, MLA) at full width, cut to
# MESH_TP_LAYERS layers, on (data 1, model 4): mamba2-1.3b's 64 SSM heads
# and minicpm3-4b's 40 MLA heads split 16 and 10 a rank.
MESH_TP = ("mamba2-1.3b", "minicpm3-4b")
MESH_TP_LAYERS = 2
MESH_TP_SHAPE = (1, 4)
MESH_TP_TOKENS = (2, 1024)                        # (batch, seq)


def mesh_tokens(np, cfg, shape, seed: int):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int64)


def mesh_cfg(arch: str, layers: int, **kw):
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch), n_layers=layers, **kw)


def moe_mesh_keep(torch, topi, route: str, lanes: int, n_experts: int, capacity_factor: float):
    """The token-copies a mesh MoE route keeps, in copy order (token · k +
    choice), for the whole batch's top-k experts ``topi`` (T, k): the
    tokens split in order into ``lanes`` data lanes ("epsum", "a2a"), or
    replicated on each ("a2a_replicated", whose lane takes the copies to
    its E/D experts).  Plain: each copy's rank among the earlier copies
    with its key is a cumulative count."""
    import torch.nn.functional as F

    t, k = topi.shape
    fe = topi.reshape(-1)
    n = fe.numel()
    lane = torch.arange(n, device=fe.device) // max(n // lanes, 1)
    e_per = n_experts // lanes

    def rank_by(key, n_keys):
        onehot = F.one_hot(key, n_keys)
        return (onehot.cumsum(0) * onehot).sum(1) - 1

    if route == "epsum":
        cap = math.ceil(t // lanes * k / n_experts * capacity_factor)
        return rank_by(lane * n_experts + fe, lanes * n_experts) < cap
    if route == "a2a_replicated":
        return rank_by(fe, n_experts) < math.ceil(t * k / e_per)
    if route != "a2a":
        raise ValueError(route)
    cap = math.ceil(t // lanes * k / lanes * capacity_factor)
    r1 = rank_by(lane * lanes + fe // e_per, lanes * lanes)
    sent = r1 < cap
    # An expert's lane receives sender s's copies at s·cap + r1 (a copy not
    # sent sorts last); it ranks them by that position.
    order = torch.argsort(torch.where(sent, lane * cap + r1, lanes * cap), stable=True)
    r2 = torch.empty_like(r1)
    r2[order] = rank_by(fe[order], n_experts)
    return sent & (r2 < math.ceil(lanes * cap / e_per))


@contextlib.contextmanager
def masked_routes(torch, L, keep_fn):
    """While active, every MoE layer's route keeps, of the token-copies it
    keeps itself, only those ``keep_fn(topi)`` keeps (in copy order): the
    one-rank route made to drop what a mesh route drops.  Yields the list
    of each call's (topi, keep in sorted order)."""
    calls, orig = [], L._route

    def route(probs, k, capacity, *experts):
        r = orig(probs, k, capacity, *experts)
        keep = r.keep & keep_fn(r.topi)[r.order]
        slot = torch.where(keep, r.slot, r.idx.numel())
        tok = torch.where(keep, r.order // k, -1).to(torch.int32)
        idx = torch.full((r.idx.numel() + 1,), -1, dtype=torch.int32,
                         device=tok.device).scatter_(0, slot, tok)[:-1]
        calls.append((r.topi, keep))
        return r._replace(keep=keep, slot=slot, idx=idx)

    L._route = route
    try:
        yield calls
    finally:
        L._route = orig


def _rank_setup(torch):
    """TF32 off, and the card's memory that an earlier case of the spawn
    left cached handed back (the ranks share the card)."""
    import gc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# Updates are compared through a CountSketch of each leaf: every element
# adds ±its value to one of SKETCH_BUCKETS buckets, the bucket and sign
# hashed from its flat index in the whole leaf (_SKETCH_HASH: (lo·a1 +
# hi·a2 + c) mod p of the index's low 22 and high bits).  The map is
# linear, so a rank sketches its shard placed in the whole leaf and the
# sum over the ranks is the whole leaf's sketch, and sketch(after) −
# sketch(before) is the update's (float64 sums of float32 values: exact
# to 1e-15 of the parameters).  ‖sketch(d)‖ estimates ‖d‖ within about
# (2 / SKETCH_BUCKETS)^½ / 2 = 0.3 % relative (exactly for a leaf of fewer
# elements than buckets but for collisions), so the update ratio needs no
# leaf copied off the card or between ranks.
SKETCH_BUCKETS = 1 << 16
_SKETCH_HASH = (1_594_350_793, 1_182_594_721, 362_436_069, 2_147_483_647)


def _sketch(torch, t, full_shape, starts):
    """The CountSketch (float64, on t's device) of ``t``, the block of a
    leaf of ``full_shape`` that starts at ``starts``."""
    a1, a2, c, p = _SKETCH_HASH
    k = SKETCH_BUCKETS
    flat = t.detach().reshape(-1)
    lshape, full, starts = list(t.shape) or [1], list(full_shape) or [1], list(starts) or [0]
    gstride = [math.prod(full[d + 1:]) for d in range(len(full))]
    out = torch.zeros(k, dtype=torch.float64, device=t.device)
    chunk = 1 << 24
    for c0 in range(0, flat.numel(), chunk):
        q = torch.arange(c0, min(flat.numel(), c0 + chunk), device=t.device)
        g = torch.zeros_like(q)
        for d in reversed(range(len(lshape))):
            g += (q % lshape[d] + starts[d]) * gstride[d]
            q = q // lshape[d]
        h = ((g & ((1 << 22) - 1)) * a1 + (g >> 22) * a2 + c) % p
        out.index_add_(0, h % k, flat[c0:c0 + g.numel()].double() * ((h // k) % 2 * 2 - 1))
    return out


def _sketches(torch, model, mesh=None) -> dict:
    """Each leaf's sketch: of the whole leaf (``mesh`` None), or of this
    rank's shard in place, on one rank of those that hold the same shard
    (zeros on the others), so that the sum over the ranks is the whole
    leaf's."""
    from repro_torch.parallel import sharding as S

    out = {}
    for name, p in model.named_parameters():
        if mesh is None:
            out[name] = _sketch(torch, p, tuple(p.shape), (0,) * p.dim())
            continue
        spec = tuple(getattr(p, "spec", ())) + (None,) * p.dim()
        axes = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
                for e in spec[:p.dim()]]
        full = tuple(d * math.prod(mesh.shape.get(a, 1) for a in ax)
                     for d, ax in zip(p.shape, axes))
        starts = tuple(sl.start for sl in S.local_slice(full, spec[:p.dim()], mesh))
        used = {a for ax in axes for a in ax}
        if all(mesh.coords[a] == 0 for a in mesh.shape if a not in used):
            out[name] = _sketch(torch, p, full, starts)
        else:
            out[name] = torch.zeros(SKETCH_BUCKETS, dtype=torch.float64, device=p.device)
    return out


def _minus(after: dict, before: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


def _update_ratio(torch, got: dict, want: dict) -> dict:
    """Each leaf's ‖got − want‖ / ‖want‖ (sketches of two updates): the
    largest and its leaf, and the range of ‖got‖ / ‖want‖."""
    worst, where, scale = -1.0, None, []
    for name, w in want.items():
        r = float((got[name] - w).norm() / w.norm().clamp_min(1e-300))
        scale.append(float(got[name].norm() / w.norm().clamp_min(1e-300)))
        if r > worst:
            worst, where = r, name
    return {"max_ratio": worst, "leaf": where, "norm_ratio": [min(scale), max(scale)],
            "leaves": len(want)}


def _compare_update(torch, mesh, model, before: dict, ref: dict | None) -> dict | None:
    """The mesh's update of each leaf (``model``'s sketches − ``before``,
    summed over the ranks) against rank 0's one-rank update sketches
    ``ref``: ``_update_ratio``'s result on rank 0, None elsewhere."""
    import torch.distributed as dist

    delta = _minus(_sketches(torch, model, mesh), before)
    names = list(delta)
    stacked = torch.stack([delta[n] for n in names]).cpu()
    dist.all_reduce(stacked)
    if mesh.rank != 0:
        return None
    got = dict(zip(names, stacked.to(ref[names[0]].device)))
    return _update_ratio(torch, got, ref)


def _scatter_rows(torch, mesh, x, ref, split: bool):
    """(max |x − ref rows|, RMS(x − ref), RMS(ref), max |ref|) over the ranks:
    ``x`` this rank's rows (its DP lane's part of the batch when ``split``),
    ``ref`` rank 0's whole host tensor."""
    import torch.distributed as dist

    recv = torch.empty(tuple(x.shape), dtype=x.dtype)
    parts = None
    if mesh.rank == 0:
        n = x.shape[0]
        parts = []
        for r in range(mesh.size):
            d = mesh.coords_of(r)["data"]
            parts.append(ref[d * n:(d + 1) * n].contiguous() if split else ref)
    dist.scatter(recv, parts, src=0)
    diff = (x.detach().float() - recv.to(x.device).float())
    mx = torch.tensor([float(diff.abs().max()), float(recv.abs().max())], dtype=torch.float64)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX)
    sums = torch.tensor([float((diff.double() ** 2).sum()), float((recv.double() ** 2).sum()),
                         float(diff.numel())], dtype=torch.float64)
    dist.all_reduce(sums)
    return (float(mx[0]), float((sums[0] / sums[2]).sqrt()), float((sums[1] / sums[2]).sqrt()),
            float(mx[1]))


def _mesh_stats(torch, dev, coll, t0) -> dict:
    return {"collectives": coll.STATS["collectives"], "bytes": coll.STATS["bytes"],
            "staged_bytes": coll.STATS["staged_bytes"],
            "kinds": {k: dict(v) for k, v in coll.STATS["kinds"].items()},
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "s": time.perf_counter() - t0}


def _mark(out: dict, label: str) -> None:
    """A point of this rank's timeline: seconds since it started its case."""
    out["timeline"].append((label, time.perf_counter() - out["t_start"]))


def mesh_qwen_rank(rank, group, dev, tokens, ckpt_dir, control):
    """qwen3-8b at full width (MESH_QWEN) on (data 2, model 2), FSDP: one
    AdamW step, then one with ``compress_grads``; each held to the one-rank
    step from the same seed on the same batch (rank 0 computes it first):
    loss, gradient norm and each leaf's update; then the first block
    group's leaves saved from (2, 2) and restored onto (4, 1) bit for bit.
    With ``control``, rank 0 also reads the first step's one-rank update of
    data lane 0's half of the batch against the whole batch's."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import compress
    from repro_torch.parallel import sharding as S
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    _rank_setup(torch)
    arch, layers, _ = MESH_QWEN
    cfg = mesh_cfg(arch, layers)
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(**MESH_OPT))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    out = {"rank": rank, "timeline": [], "t_start": time.perf_counter()}
    ref = {}
    if rank == 0:
        t0 = time.perf_counter()
        model = T.init_params(cfg, MESH_SEED, device=dev, trainable=True)
        s0 = _sketches(torch, model)
        _mark(out, "one_rank sketch")
        state = step_mod.state_for(model, tcfg)
        state = state._replace(step=torch.ones_like(state.step))   # lr > 0 at once
        step_fn = step_mod.build_train_step(cfg, tcfg, par.ParallelCtx())
        state, m1 = step_fn(state, batch)
        _mark(out, "one_rank step 1")
        s1 = _sketches(torch, model)
        ref["step1"] = _minus(s1, s0)
        loss2, grads = step_mod._loss_and_grads(cfg, tcfg, model, batch)
        grads = compress.compress_decompress(grads)
        _, opt, m2 = opt_mod.apply_updates(tcfg.opt, grads, state.opt, model, state.step)
        del grads, opt
        ref["step2"] = _minus(_sketches(torch, model), s1)
        _mark(out, "one_rank step 2")
        out["one_rank"] = {"loss": [float(m1["loss"]), float(loss2)],
                           "gnorm": [float(m1["gnorm"]), float(m2["gnorm"])],
                           "s": time.perf_counter() - t0,
                           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del model, state, step_fn, m1, m2
        torch.cuda.empty_cache()
        if control:
            # The control: data lane 0's half of the batch.
            model = T.init_params(cfg, MESH_SEED, device=dev, trainable=True)
            state = step_mod.state_for(model, tcfg)
            state = state._replace(step=torch.ones_like(state.step))
            step_mod.build_train_step(cfg, tcfg, par.ParallelCtx())(
                state, {"tokens": batch["tokens"][:tokens.shape[0] // MESH_SHAPE[0]]})
            half = _minus(_sketches(torch, model), s0)
            del model, state
            torch.cuda.empty_cache()
            out["control_half_batch"] = _update_ratio(torch, half, ref["step1"])
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    mesh = mesh_mod.make_mesh(MESH_SHAPE, MESH_AXES, group, device=dev)
    pctx = par.ParallelCtx(mesh=mesh, fsdp=True)
    state = step_mod.make_train_state(cfg, tcfg, gen=MESH_SEED, device=dev, pctx=pctx)
    state = state._replace(step=torch.ones_like(state.step))
    before = _sketches(torch, state.params, mesh)
    _mark(out, "mesh state")
    # Step 1's peak is the step's (the state resident): lm_dryrun predicts it.
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    coll.reset_stats()
    ops.reset_launch_counts()
    state, m1 = step_mod.build_train_step(cfg, tcfg, pctx)(state, batch)
    torch.cuda.synchronize()
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["step1"] = {"loss": float(m1["loss"]), "gnorm": float(m1["gnorm"]),
                    **_mesh_stats(torch, dev, coll, t0)}
    _mark(out, "step 1")
    out["step1"]["update"] = _compare_update(torch, mesh, state.params, before,
                                             ref.pop("step1", None))
    _mark(out, "compare 1")
    before = _sketches(torch, state.params, mesh)
    t1 = time.perf_counter()
    coll.reset_stats()
    state, m2 = step_mod.build_train_step(
        cfg, tcfg, dataclasses.replace(pctx, compress_grads=True))(state, batch)
    torch.cuda.synchronize()
    out["step2"] = {"loss": float(m2["loss"]), "gnorm": float(m2["gnorm"]),
                    **_mesh_stats(torch, dev, coll, t1)}
    _mark(out, "step 2")
    out["step2"]["update"] = _compare_update(torch, mesh, state.params, before,
                                             ref.pop("step2", None))
    _mark(out, "compare 2")
    del before
    out["backend"], out["staged"] = mesh.backend, mesh.staged
    # The elastic restore: the first block group's leaves from (2, 2) onto
    # (4, 1).
    t2 = time.perf_counter()
    blocks = {name: p for name, p in state.params.named_parameters()
              if name.startswith("blocks.0.")}
    with par.use(pctx):
        ck.save(ckpt_dir, blocks, 1)
    mesh41 = mesh_mod.make_mesh((4, 1), MESH_AXES, group, device=dev)
    pctx41 = par.ParallelCtx(mesh=mesh41, fsdp=True)
    specs = dict(T.leaf_specs(cfg, pctx41))
    like = {name: torch.empty(0, device=dev) for name in blocks}
    restored, _ = ck.restore(ckpt_dir, like, shardings={n: S.Spec(specs[n]) for n in blocks},
                             mesh=mesh41)
    equal = True
    for name, p in blocks.items():
        whole = S.unshard(p.detach(), p.spec, mesh)
        mine = whole[S.local_slice(tuple(whole.shape), specs[name], mesh41)]
        equal &= bool(torch.equal(mine, restored[name]))
        del whole, mine
    flags = torch.tensor([0.0 if equal else 1.0])
    dist.all_reduce(flags)
    out["elastic"] = {"from": "(data 2, model 2)", "to": "(data 4, model 1)",
                      "leaves": len(blocks),
                      "bytes_per_rank": sum(p.numel() * p.element_size() for p in blocks.values()),
                      "bit_identical": float(flags) == 0.0,
                      "s": time.perf_counter() - t2}
    _mark(out, "elastic")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if rank == 0:
        log(f"lm_mesh qwen3 rank 0: {json.dumps(out)}")
    return out


def mesh_tp_rank(rank, group, dev, arch, tokens):
    """``arch`` at full width (MESH_TP_LAYERS layers) on MESH_TP_SHAPE, FSDP,
    its Mamba-2 or MLA layers computed on their shards: one AdamW step held
    to the one-rank step from the same seed on the same batch (rank 0
    computes it first): loss, gradient norm and each leaf's update; and
    every B7 / B8 call of the mesh step with the heads, head dim and dtype
    it got, and the route each launch took."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par
    from repro_torch.parallel import collectives as coll
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    _rank_setup(torch)
    cfg = mesh_cfg(arch, MESH_TP_LAYERS)
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(**MESH_OPT))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    out = {"rank": rank}
    ref = None
    if rank == 0:
        t0 = time.perf_counter()
        model = T.init_params(cfg, MESH_SEED, device=dev, trainable=True)
        s0 = _sketches(torch, model)
        state = step_mod.state_for(model, tcfg)
        state = state._replace(step=torch.ones_like(state.step))   # lr > 0 at once
        state, m1 = step_mod.build_train_step(cfg, tcfg, par.ParallelCtx())(state, batch)
        ref = _minus(_sketches(torch, model), s0)
        out["one_rank"] = {"loss": float(m1["loss"]), "gnorm": float(m1["gnorm"]),
                           "s": time.perf_counter() - t0,
                           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del model, state, m1
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    mesh = mesh_mod.make_mesh(MESH_TP_SHAPE, MESH_AXES, group, device=dev)
    pctx = par.ParallelCtx(mesh=mesh, fsdp=True)
    state = step_mod.make_train_state(cfg, tcfg, gen=MESH_SEED, device=dev, pctx=pctx)
    state = state._replace(step=torch.ones_like(state.step))
    before = _sketches(torch, state.params, mesh)
    calls: dict = {}
    real = ops.flash_attention, ops.ssd_scan

    def seen(name, t, heads_dim):
        key = f"{name} heads={t.shape[heads_dim]} d={t.shape[-1]} {str(t.dtype)[6:]}"
        calls[key] = calls.get(key, 0) + 1

    def attention(q, k, v, **kw):
        seen("flash_attention", q, 1)
        return real[0](q, k, v, **kw)

    def scan(x, a, b, c):
        seen("ssd_scan", x, 2)
        return real[1](x, a, b, c)

    ops.reset_launch_counts()
    coll.reset_stats()
    t0 = time.perf_counter()
    ops.flash_attention, ops.ssd_scan = attention, scan
    try:
        state, m = step_mod.build_train_step(cfg, tcfg, pctx)(state, batch)
        torch.cuda.synchronize()
    finally:
        ops.flash_attention, ops.ssd_scan = real
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["routes"] = {"flash_attention": dict(fa.route_launches),
                     "ssd_scan": dict(ssd.route_launches)}
    out["calls"] = calls
    out["step"] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                   **_mesh_stats(torch, dev, coll, t0)}
    out["step"]["update"] = _compare_update(torch, mesh, state.params, before, ref)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if rank == 0:
        log(f"lm_mesh {arch} rank 0: {json.dumps(out)}")
    return out


def _tp_gates(arch: str, recs: list, cfg) -> list:
    """A MESH_TP step against its one-rank step, and its kernels: one B8
    (Mamba-2) or B7 (MLA) launch a layer on every rank, each on the rank's
    heads."""
    r0 = recs[0]
    fails = _step_gates(f"{arch} mesh step", r0["step"], r0["one_rank"]["loss"],
                        r0["one_rank"]["gnorm"], "exact")
    m = MESH_TP_SHAPE[1]
    kernel, heads = (("ssd_scan", cfg.ssm_heads // m) if cfg.ssm_state
                     else ("flash_attention", cfg.n_heads // m))
    for r in recs:
        if r["launches"] != {kernel: cfg.n_layers}:
            fails.append(f"{arch} rank {r['rank']}: launches {r['launches']}")
        if sum(r["calls"].values()) != cfg.n_layers or any(
                f"heads={heads} " not in key for key in r["calls"]):
            fails.append(f"{arch} rank {r['rank']}: calls {r['calls']}")
    return fails


# name -> (moe_impl, a2a_int8, batch key, the route whose drops its
# one-rank reference applies) of the llama4-scout forwards.
MESH_MOE_CASES = {"epsum": ("epsum", False, "b4", "epsum"),
                  "a2a": ("a2a", False, "b4", "a2a"),
                  "a2a_int8": ("a2a", True, "b4", "a2a"),
                  "a2a_replicated": ("a2a", False, "b1", "a2a_replicated")}


def _llama_keep(torch, cfg, route):
    return lambda topi: moe_mesh_keep(torch, topi, route, MESH_SHAPE[0], cfg.n_experts,
                                      cfg.capacity_factor)


def mesh_llama_rank(rank, group, dev, tokens, tokens1, tokens_step, control):
    """llama4-scout at full width (MESH_LLAMA) on (data 2, model 2), at its
    published capacity factor: the forward under epsum, a2a and a2a +
    a2a_int8 at 4 × 2,048 tokens, the a2a branch with the tokens
    replicated at batch 1, and one Adafactor step under a2a without and
    one with the int8 wire (FSDP, 2 × 1,024 tokens), each held to the
    one-rank run that rank 0 computes first: the "local" route at capacity
    factor E with the mesh route's drops applied.  With ``control``, rank 0
    also reads the step's one-rank update of data lane 0's half of the
    batch against the whole batch's."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import moe_gather, ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par
    from repro_torch.parallel import collectives as coll
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    _rank_setup(torch)
    arch, layers, _, _ = MESH_LLAMA
    cfg = mesh_cfg(arch, layers)
    whole = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))   # drops nothing
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(name="adafactor", **MESH_OPT))
    toks = {"b4": torch.as_tensor(tokens, device=dev), "b1": torch.as_tensor(tokens1, device=dev)}
    step_batch = {"tokens": torch.as_tensor(tokens_step, device=dev)}
    scalar_keys = [f"{r}/{q}" for r in ("epsum", "a2a", "a2a_replicated")
                   for q in ("aux", "loss", "dropped")] + ["step_loss", "step_gnorm"]
    out = {"rank": rank, "forward": {}, "timeline": [], "t_start": time.perf_counter()}
    ref = {}
    if rank == 0:
        t0 = time.perf_counter()
        model = T.init_params(whole, MESH_SEED, device=dev)
        _mark(out, "one_rank init")
        with torch.no_grad():
            for route, key in (("epsum", "b4"), ("a2a", "b4"), ("a2a_replicated", "b1")):
                t = toks[key]
                with masked_routes(torch, L, _llama_keep(torch, cfg, route)) as calls:
                    x, aux = T._hidden(whole, model, t, None, None, "cfg")
                    ref[route] = x.cpu()
                    ref[route + "/aux"] = float(aux)
                    ref[route + "/loss"] = float(T.loss_fn(whole, model, {"tokens": t}))
                ref[route + "/dropped"] = float((~calls[0][1]).sum())
                del x
                _mark(out, "one_rank forward")
        model.requires_grad_(True)
        s0 = _sketches(torch, model)
        state = step_mod.state_for(model, tcfg)
        state = state._replace(step=torch.ones_like(state.step))
        _mark(out, "one_rank sketch")
        with masked_routes(torch, L, _llama_keep(torch, cfg, "a2a")) as calls:
            state, m = step_mod.build_train_step(whole, tcfg, par.ParallelCtx())(
                state, step_batch)
        ref["step_loss"], ref["step_gnorm"] = float(m["loss"]), float(m["gnorm"])
        ref["step_dropped"] = int((~calls[0][1]).sum())
        ref["step"] = _minus(_sketches(torch, model), s0)
        _mark(out, "one_rank step")
        out["one_rank"] = {"s": time.perf_counter() - t0,
                           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                           **{k: v for k, v in ref.items() if isinstance(v, (int, float))}}
        del model, state, m
        torch.cuda.empty_cache()
        if control:
            model = T.init_params(whole, MESH_SEED, device=dev, trainable=True)
            state = step_mod.state_for(model, tcfg)
            state = state._replace(step=torch.ones_like(state.step))
            half = {"tokens": step_batch["tokens"][:tokens_step.shape[0] // MESH_SHAPE[0]]}
            with masked_routes(torch, L, _llama_keep(torch, cfg, "a2a")):
                step_mod.build_train_step(whole, tcfg, par.ParallelCtx())(state, half)
            half = _minus(_sketches(torch, model), s0)
            del model, state
            torch.cuda.empty_cache()
            out["control_half_batch"] = _update_ratio(torch, half, ref["step"])
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    mesh = mesh_mod.make_mesh(MESH_SHAPE, MESH_AXES, group, device=dev)
    scalars = torch.tensor([float(ref.get(k, 0.0)) for k in scalar_keys], dtype=torch.float64)
    dist.broadcast(scalars, src=0)
    ref_scalars = dict(zip(scalar_keys, scalars.tolist()))
    model, built_for = None, None
    for name, (impl, int8, key, ref_route) in MESH_MOE_CASES.items():
        t0 = time.perf_counter()
        pctx = par.ParallelCtx(mesh=mesh, moe_impl=impl, a2a_int8=int8)
        if built_for != impl:
            model = None
            torch.cuda.empty_cache()
            model = T.init_params(cfg, MESH_SEED, device=dev, pctx=pctx)
            built_for = impl
        local, split = pctx.shard_batch({"tokens": toks[key]})
        coll.reset_stats()
        ops.reset_launch_counts()
        with torch.no_grad(), par.use(dataclasses.replace(pctx, batch_sharded=split)):
            route = L.moe_route(cfg)
            x, aux = T._hidden(cfg, model, local["tokens"], None, None, "cfg")
            loss = float(T.loss_fn(cfg, model, local))
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        mx, rms, ref_rms, ref_max = _scatter_rows(torch, mesh, x, ref.get(ref_route), split)
        out["forward"][name] = {
            "route": route, "tokens": list(toks[key].shape), "split": split,
            "dropped_copies": int(ref_scalars[ref_route + "/dropped"]),
            "launches": launches, "int8_launches": moe_gather.mode_launches["int8"],
            "max_abs": mx, "max_abs_one_rank": ref_max, "rms_ratio": rms / ref_rms,
            "aux": float(aux), "aux_one_rank": ref_scalars[ref_route + "/aux"], "loss": loss,
            "loss_one_rank": ref_scalars[ref_route + "/loss"],
            **_mesh_stats(torch, dev, coll, t0)}
        del x
        _mark(out, "forward")
    del model
    ref = {"step": ref.get("step")}
    torch.cuda.empty_cache()
    # The Adafactor step under a2a, FSDP: without the int8 wire (exact), then with it.
    out["step"] = {}
    for name, int8 in (("a2a", False), ("a2a_int8", True)):
        pctx = par.ParallelCtx(mesh=mesh, fsdp=True, moe_impl="a2a", a2a_int8=int8)
        state = step_mod.make_train_state(cfg, tcfg, gen=MESH_SEED, device=dev, pctx=pctx)
        state = state._replace(step=torch.ones_like(state.step))
        before = _sketches(torch, state.params, mesh)
        _mark(out, "step state")
        t0 = time.perf_counter()
        coll.reset_stats()
        ops.reset_launch_counts()
        state, m = step_mod.build_train_step(cfg, tcfg, pctx)(state, step_batch)
        torch.cuda.synchronize()
        out["step"][name] = {
            "optimizer": "adafactor", "tokens": list(step_batch["tokens"].shape),
            "loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "loss_one_rank": ref_scalars["step_loss"],
            "gnorm_one_rank": ref_scalars["step_gnorm"],
            "launches": {k: v for k, v in ops.launch_counts().items() if v},
            "int8_launches": moe_gather.mode_launches["int8"],
            **_mesh_stats(torch, dev, coll, t0)}
        out["step"][name]["update"] = _compare_update(torch, mesh, state.params, before,
                                                      ref["step"])
        _mark(out, "step and compare")
        del state, m, before
        torch.cuda.empty_cache()
    out["backend"], out["staged"] = mesh.backend, mesh.staged
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if rank == 0:
        log(f"lm_mesh llama4 rank 0: {json.dumps(out)}")
    return out


def mesh_b9_int8(torch, ops, ref, dev) -> dict:
    """B9's int8 mode at the a2a send-buffer shape of the llama4 run (4,096
    local tokens, top-1, 2 ``data`` lanes of ⌈4,096 / 2 · 1.25⌉ = 2,560
    slots): the kernel against its plain version bit for bit, timed beside
    it and ``index_select``; bound by bytes (kept rows read, ids read, int8
    rows and scales written)."""
    _, _, (b, s), _ = MESH_LLAMA
    cfg = mesh_cfg(MESH_LLAMA[0], MESH_LLAMA[1])
    t = b * s // MESH_SHAPE[0]
    lanes = MESH_SHAPE[0]
    cap = int(math.ceil(t * cfg.topk / lanes * cfg.capacity_factor))
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((t, cfg.d_model), generator=g, device=dev)
    dest = torch.randint(0, lanes, (t,), generator=g, device=dev)
    idx = torch.full((lanes, cap), -1, dtype=torch.int32, device=dev)
    for lane in range(lanes):
        tok = torch.nonzero(dest == lane)[:cap, 0].to(torch.int32)
        idx[lane, :tok.numel()] = tok
    idx = idx.reshape(-1)
    got, want = ops.dispatch_gather(x, idx, quant=True), ref.dispatch_gather(x, idx, quant=True)
    torch.cuda.synchronize()
    if not (same(torch, got[0], want[0]) and same(torch, got[1], want[1])):
        raise RuntimeError("dispatch_gather int8 at the a2a send shape: kernel differs from "
                           "its plain version")
    kept = int((idx >= 0).sum())
    d = cfg.d_model
    nbytes = kept * d * 4 + idx.numel() * 4 + idx.numel() * d + idx.numel() * 4
    ops_count = kept * d * 6
    return {"shape": [t, d, idx.numel(), "float32"], "kept_rows": kept, "exact": True,
            "max_abs_err": 0.0,
            "ms": median_ms(torch, lambda: ops.dispatch_gather(x, idx, quant=True), 20, per=10),
            "plain_ms": median_ms(torch, lambda: ref.dispatch_gather(x, idx, quant=True), 5),
            "library_ms": median_ms(torch, lambda: x.index_select(0, idx.clamp_min(0)), 20,
                                    per=10),
            "bound_ms": bound(ops_count, nbytes)[0], "bound_by": bound(ops_count, nbytes)[1],
            "bytes": nbytes, "operations": ops_count}


# -- the LM kernels at the training shapes (PR 28's entries) -------------------

# B7 and B8 at the float32 training forward of lm_train (qwen3-8b's and
# mamba2-1.3b's layer at 2 × 2,048 tokens), B9 at llama4-scout's (4,096
# tokens, top-1 over 16 experts at capacity factor 1.25).
TRAIN_SHAPE_FA = (2, 32, 8, 2048, 128)          # b, h, hkv, s, d
TRAIN_SHAPE_SSD = (2, 2048, 64, 64, 128)        # b, l, h, dh, ds
TRAIN_SHAPE_GATHER = (4096, 5120, 16, 1.25)     # tokens, d, experts, capacity factor


def train_shape_entries(torch, ops, ref, dev) -> dict:
    """B7, B8 and B9 on seeded float32 inputs at the training forward's
    shapes: each held to its plain version (B7/B8 at LM_KERNEL_F32_TOL, B9
    bit for bit) and timed beside it, with its bound and the library call
    where there is one (SDPA in float32; ``index_select`` of the same
    rows).  Returns {kernel name: its ``at_training_shape`` entry}."""
    g = torch.Generator(device=dev).manual_seed(28)
    out = {}
    b, h, hkv, s, d = TRAIN_SHAPE_FA
    q = torch.randn((b, h, s, d), generator=g, device=dev)
    k, v = (torch.randn((b, hkv, s, d), generator=g, device=dev) for _ in range(2))
    ops_fa = b * h * _flash_pairs(s, s, True) * 4 * d
    bytes_fa = tensor_bytes(q) * 2 + tensor_bytes(k) + tensor_bytes(v)
    out["flash_attention"] = kernel_entry(
        torch, "flash_attention", "flash_attention.cu", LM_KERNEL_REPLACES["flash_attention"],
        [b, h, hkv, s, d, "float32"], lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_chunked(q, k, v, causal=True), *bound(ops_fa, bytes_fa),
        None, "the float32 training forward (lm_train)",
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        tol=LM_KERNEL_F32_TOL["flash_attention"],
        extra={"operations": ops_fa, "bytes": bytes_fa})
    del q, k, v
    bsz, l, hs, dh, ds = TRAIN_SHAPE_SSD
    x = torch.randn((bsz, l, hs, dh), generator=g, device=dev)
    a = -0.7 * torch.rand((bsz, l, hs), generator=g, device=dev)
    bb = torch.randn((bsz, l, hs, ds), generator=g, device=dev)
    c = torch.randn((bsz, l, 1, ds), generator=g, device=dev).expand(bsz, l, hs, ds)
    lc = 32     # the CUDA-core route's chunk (ssd_scan.CHUNK["simt"])
    ops_ssd = bsz * l * hs * ((lc + 1) * (ds + dh) + 4 * ds * dh)
    bytes_ssd = tensor_bytes(x) * 2 + tensor_bytes(a) + tensor_bytes(bb) + tensor_bytes(c)
    out["ssd_scan"] = kernel_entry(
        torch, "ssd_scan", "ssd_scan.cu", LM_KERNEL_REPLACES["ssd_scan"],
        [bsz, l, hs, dh, ds, "float32"], lambda: ops.ssd_scan(x, a, bb, c),
        lambda: ref.ssd_scan_chunked(x, a, bb, c, chunk=ops.PLAIN_SSD_CHUNK),
        *bound(ops_ssd, bytes_ssd), None, "the float32 training forward (lm_train)",
        tol=LM_KERNEL_F32_TOL["ssd_scan"],
        extra={"operations": ops_ssd, "bytes": bytes_ssd, "chunk": lc})
    del x, a, bb, c
    t, dm, e, cf = TRAIN_SHAPE_GATHER
    cap = math.ceil(t / e * cf)
    xg = torch.randn((t, dm), generator=g, device=dev)
    dest = torch.randint(0, e, (t,), generator=g, device=dev)
    idx = torch.full((e, cap), -1, dtype=torch.int32, device=dev)
    for ex in range(e):
        tok = torch.nonzero(dest == ex)[:cap, 0].to(torch.int32)
        idx[ex, :tok.numel()] = tok
    idx = idx.reshape(-1)
    kept = int((idx >= 0).sum())
    bytes_g = kept * dm * 4 + idx.numel() * 4 + idx.numel() * dm * 4 + idx.numel() * 4
    out["dispatch_gather"] = kernel_entry(
        torch, "dispatch_gather", "moe_gather.cu", LM_KERNEL_REPLACES["dispatch_gather"],
        [t, dm, idx.numel(), "float32"], lambda: ops.dispatch_gather(xg, idx, quant=False)[0],
        lambda: ref.dispatch_gather(xg, idx, quant=False)[0], *bound(0, bytes_g), None,
        "the float32 training forward (lm_train)",
        library=lambda: xg.index_select(0, idx.clamp_min(0)),
        extra={"bytes": bytes_g, "kept_rows": kept,
               "library": "index_select (no mask, no quantisation)"})
    keep = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "exact", "operations", "bytes", "kept_rows", "library", "chunk")
    return {name: {k: e_[k] for k in keep if k in e_} for name, e_ in out.items()}


# -- the LM dry run (lm_dryrun) ------------------------------------------------

# The predicted peak of lm_mesh's qwen3-8b mesh step against the measured
# one (each rank's ``max_memory_allocated`` over step 1), relative.
DRYRUN_PEAK_RTOL = 0.15
# Two production cells on (data 16, model 16), each traced as one rank.
DRYRUN_LM_CELLS = (("qwen3-8b", "train_4k"), ("llama4-scout-17b-a16e", "prefill_32k"))


def lm_dryrun_phase(torch, ops, mesh_line: dict, card: str) -> dict:
    """The port's LM dry run (launch/dryrun.py) in this process, on meta
    tensors in a fake world: lm_mesh's qwen3-8b step (2 of 36 layers,
    (data 2, model 2), FSDP, AdamW, 2 × 2,048 tokens, float32) held to what
    lm_mesh measured on its ranks (collectives by kind exactly; the peak
    within DRYRUN_PEAK_RTOL of the ranks that ran only the mesh step), then
    DRYRUN_LM_CELLS and kimi-k2's scale-out on 2,048 ranks, each with its
    trace time.  Launches no kernel."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun, dryrun_scaleout
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    t_phase = time.perf_counter()
    launches0 = ops.launch_counts()
    failures = []
    arch, layers, (b, s) = MESH_QWEN
    rec = dryrun.run_cell(arch, "lm_mesh", False, pctx_overrides=dict(fsdp=True, remat="none"),
                          tcfg=step_mod.TrainConfig(opt=opt_mod.OptConfig(**MESH_OPT)),
                          cfg=mesh_cfg(arch, layers), shape=ShapeConfig("lm_mesh", s, b, "train"),
                          mesh=(MESH_SHAPE, MESH_AXES))
    if rec["status"] != "ok":
        raise RuntimeError(f"lm_dryrun: the lm_mesh cell failed: {rec.get('trace')}")
    measured = mesh_line["qwen3"]["step1_ranks"]
    for i, st in enumerate(measured):
        counts = {k: v["calls"] for k, v in st["kinds"].items()}
        nbytes = {k: v["bytes"] for k, v in st["kinds"].items()}
        if counts != rec["coll_counts"] or nbytes != rec["coll_detail"]:
            failures.append(f"rank {i}: collectives {counts} / {nbytes}, predicted "
                            f"{rec['coll_counts']} / {rec['coll_detail']}")
    predicted_gb = rec["memory"]["total_hbm_bytes"] / 1e9
    peaks = [st["peak_gb"] for st in measured[1:]]    # the ranks that ran only the mesh step
    ratios = [predicted_gb / p for p in peaks]
    if any(abs(r - 1) > DRYRUN_PEAK_RTOL for r in ratios):
        failures.append(f"predicted peak {predicted_gb} GB against measured {peaks}")
    cross = {"arch": arch, "layers": layers, "tokens": [b, s], "mesh": dict(zip(MESH_AXES,
                                                                               MESH_SHAPE)),
             "coll_counts": rec["coll_counts"], "coll_detail": rec["coll_detail"],
             "measured_collectives": [st["kinds"] for st in measured],
             "predicted_peak_gb": predicted_gb, "measured_peak_gb": peaks,
             "peak_ratio": ratios, "memory": rec["memory"], "trace_s": rec["trace_s"]}
    cells = []
    for arch_c, shape_c in DRYRUN_LM_CELLS:
        r = dryrun.run_cell(arch_c, shape_c, False)
        if r["status"] != "ok":
            failures.append(f"{arch_c} {shape_c}: {r.get('error')}")
        cells.append({k: r.get(k) for k in dryrun.SHORT_KEYS + (
            "flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev", "memory", "kernels",
            "traced")})
    scale = dryrun_scaleout.run()
    if not scale["fits_h100_80gb"]:
        failures.append(f"kimi-k2's scale-out does not fit: {scale['hbm_per_device_gb']} GiB")
    if ops.launch_counts() != launches0:
        failures.append("the dry run launched a kernel")
    line = {"card": card, "lm_mesh_cross_check": cross, "cells": cells, "scaleout": scale,
            "failures": failures, "lm_dryrun_phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"lm_dryrun": line}), flush=True)
    if failures:
        raise RuntimeError(f"lm_dryrun: {failures}")
    return line


def mesh_nccl_rank(rank, group, dev, tokens):
    """One rank on NCCL (each rank its own card: here one rank, one card): a
    (data 1, model 1) mesh and one AdamW step of qwen3-8b at full width
    (MESH_QWEN's depth), an all-reduce on the group to show NCCL runs."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import api as par
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    _rank_setup(torch)
    mesh = mesh_mod.make_mesh((1, 1), MESH_AXES, group, device=dev)
    probe = torch.ones(4, device=dev)
    dist.all_reduce(probe)
    cfg = mesh_cfg(MESH_QWEN[0], MESH_QWEN[1])
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(**MESH_OPT))
    pctx = par.ParallelCtx(mesh=mesh, fsdp=True)
    state = step_mod.make_train_state(cfg, tcfg, gen=MESH_SEED, device=dev, pctx=pctx)
    state, m = step_mod.build_train_step(cfg, tcfg, pctx)(
        state, {"tokens": torch.as_tensor(tokens, device=dev)})
    torch.cuda.synchronize()
    return {"backend": mesh.backend, "staged": mesh.staged, "loss": float(m["loss"]),
            "all_reduce": float(probe.sum()), "device_count": torch.cuda.device_count()}


def _step_gates(tag: str, got: dict, loss_one: float, gnorm_one: float, kind: str) -> list:
    """A mesh step against the one-rank step: loss, gradient norm and each
    leaf's update (MESH_* tolerances above; ``kind`` "exact", "compress"
    or "int8")."""
    fails = []
    loss_tol = MESH_INT8_LOSS_RTOL if kind == "int8" else MESH_LOSS_RTOL
    if not abs(got["loss"] - loss_one) <= loss_tol * abs(loss_one):
        fails.append(f"{tag} loss {got['loss']} vs {loss_one}")
    if not abs(got["gnorm"] - gnorm_one) <= MESH_GNORM_RTOL * abs(gnorm_one):
        fails.append(f"{tag} gnorm {got['gnorm']} vs {gnorm_one}")
    if not got["update"]["max_ratio"] <= MESH_UPDATE_RTOL[kind]:
        fails.append(f"{tag} update {got['update']}")
    return fails


def lm_mesh_phase(torch, np, ops, ref, dev, card: str, control: bool = False
                  ) -> tuple[dict, dict]:
    """The lm_mesh phase: qwen3-8b and llama4-scout at full width over 4
    ranks on this card, mamba2-1.3b's and minicpm3-4b's layers computed on
    their shards over 4 ranks (MESH_TP), the serve CLI over 2, NCCL at
    world size 1, and B9's int8 mode at the a2a send shape.  ``control``
    adds the half-batch update controls (tools/mesh_phase.py --control).
    Returns (its line, the int8 kernel entry)."""
    import argparse
    import tempfile

    from repro_torch.launch import ranks
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    failures = []
    qcfg = mesh_cfg(MESH_QWEN[0], MESH_QWEN[1])
    lcfg = mesh_cfg(MESH_LLAMA[0], MESH_LLAMA[1])
    tokens_q = mesh_tokens(np, qcfg, MESH_QWEN[2], 1)
    tokens_l = mesh_tokens(np, lcfg, MESH_LLAMA[2], 2)
    tokens_s = mesh_tokens(np, lcfg, MESH_LLAMA[3], 3)
    tp_cfgs = {a: mesh_cfg(a, MESH_TP_LAYERS) for a in MESH_TP}
    timing: dict = {}
    with tempfile.TemporaryDirectory(prefix="lm-mesh-") as tmp:
        t0 = time.perf_counter()
        qwen, llama, *tp = ranks.run_cases(
            [ranks.Case(mesh_qwen_rank, 4, (tokens_q, tmp + "/ckpt", control)),
             ranks.Case(mesh_llama_rank, 4, (tokens_l, tokens_l[:1], tokens_s, control))]
            + [ranks.Case(mesh_tp_rank, 4, (a, mesh_tokens(np, c, MESH_TP_TOKENS, 4)))
               for a, c in tp_cfgs.items()],
            4, device=dev.type, timing=timing, timeout=900)
        spawn_s = time.perf_counter() - t0
    q0, l0 = qwen[0], llama[0]
    tp = dict(zip(MESH_TP, tp))
    for arch, recs in tp.items():
        failures += _tp_gates(arch, recs, tp_cfgs[arch])
    # qwen3-8b: both steps against the one-rank steps.
    for i, key in enumerate(("step1", "step2")):
        failures += _step_gates(f"qwen3 {key}", q0[key], q0["one_rank"]["loss"][i],
                                q0["one_rank"]["gnorm"][i], ("exact", "compress")[i])
    if not q0["elastic"]["bit_identical"]:
        failures.append("qwen3 elastic restore (2, 2) -> (4, 1) differs")
    if q0["launches"].get("flash_attention", 0) < 1:
        failures.append(f"qwen3 mesh step launched {q0['launches']}")
    # llama4-scout: each forward against the one-rank route with its drops.
    b9_launches = 0
    for name, f in l0["forward"].items():
        want_route = MESH_MOE_CASES[name][0]
        int8 = MESH_MOE_CASES[name][1]
        if f["route"] != want_route:
            failures.append(f"llama4 {name}: route {f['route']}")
        if int8 and f["split"]:       # the replicated branch has no wire
            if f["rms_ratio"] > MESH_INT8_RMS:
                failures.append(f"llama4 {name}: RMS ratio {f['rms_ratio']}")
        elif f["max_abs"] > MESH_HIDDEN_TOL[1] + MESH_HIDDEN_TOL[0] * f["max_abs_one_rank"]:
            failures.append(f"llama4 {name}: max |mesh - one rank| {f['max_abs']}")
        if abs(f["aux"] - f["aux_one_rank"]) > 1e-3 * abs(f["aux_one_rank"]):
            failures.append(f"llama4 {name}: aux {f['aux']} vs {f['aux_one_rank']}")
        if abs(f["loss"] - f["loss_one_rank"]) > (
                MESH_INT8_LOSS_RTOL if int8 and f["split"] else MESH_LOSS_RTOL) * abs(
                    f["loss_one_rank"]):
            failures.append(f"llama4 {name}: loss {f['loss']} vs {f['loss_one_rank']}")
        want = {"flash_attention", "dispatch_gather"}
        per_rank = [r["forward"][name]["launches"] for r in llama]
        if any(set(lr) != want for lr in per_rank):
            failures.append(f"llama4 {name}: launches {per_rank}")
        # One send-path launch a MoE layer in each of the two passes (the
        # hidden states, the loss).
        int8_per_rank = [r["forward"][name]["int8_launches"] for r in llama]
        n_moe = lcfg.n_groups * sum(moe for _, moe in lcfg.layer_kinds())
        if int8_per_rank != [2 * n_moe if int8 and f["split"] else 0] * len(llama):
            failures.append(f"llama4 {name}: int8 launches {int8_per_rank}")
        b9_launches += sum(int8_per_rank)
    for name, st in l0["step"].items():
        failures += _step_gates(f"llama4 step {name}", st, st["loss_one_rank"],
                                st["gnorm_one_rank"], "int8" if name.endswith("int8") else "exact")
    b9_step = sum(r["step"]["a2a_int8"]["int8_launches"] for r in llama)
    if [r["step"]["a2a"]["int8_launches"] for r in llama] != [0] * len(llama):
        failures.append("llama4 step a2a: the int8 wire ran without a2a_int8")
    # The serve CLI's LM loop over 2 ranks against one card, at a cut depth.
    t_serve = time.perf_counter()
    arch, layers, n = MESH_SERVE
    args = dict(arch=arch, tiny=False, requests=4, prompt_len=128, gen=8, temperature=0.0,
                seed=0, device="cuda")
    cut = mesh_cfg(arch, layers)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        one = serve.serve_lm(argparse.Namespace(**args, mesh_devices=0), cfg=cut)
        torch.cuda.empty_cache()
        many = serve.serve_lm(argparse.Namespace(**args, mesh_devices=n), cfg=cut)
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    serve_line = {"args": args, "layers": layers, "mesh_devices": n, "tokens_equal": bool(
        torch.equal(one.cpu(), many.cpu())), "one_card": lines[0], "ranks": lines[1],
                  "s": time.perf_counter() - t_serve}
    if not serve_line["tokens_equal"] or lines[1].get("ranks") != n:
        failures.append(f"serve over {n} ranks: {serve_line}")
    torch.cuda.empty_cache()
    # NCCL at world size 1.
    t_nccl = time.perf_counter()
    nccl_timing: dict = {}
    nccl = ranks.run_cases([ranks.Case(mesh_nccl_rank, 1, (tokens_q[:1, :512],))], 1,
                           device=dev.type, timing=nccl_timing, timeout=600)[0][0]
    nccl.update(timing=nccl_timing, s=time.perf_counter() - t_nccl,
                note=f"{torch.cuda.device_count()} card(s) on this machine: NCCL ran at world "
                     "size 1 only; several cards were not available")
    if nccl["backend"] != "nccl" or nccl_timing.get("backend") != "nccl" \
            or not math.isfinite(nccl["loss"]) or nccl["all_reduce"] != 4.0:
        failures.append(f"nccl world 1: {nccl}")
    b9 = mesh_b9_int8(torch, ops, ref, dev)
    b9["launches"] = b9_launches
    b9["launches_in_the_step"] = b9_step
    if b9_launches < 1:
        failures.append("B9's int8 mode was not launched on the a2a path")
    line = {"card": card, "ranks": 4, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
            "backend": q0["backend"], "staged": q0["staged"], "spawn": timing,
            "spawn_call_s": spawn_s,
            "note": "the 4 ranks time-slice one card and every collective stages through "
                    "the host over gloo: no collective bandwidth here is NCCL's",
            "qwen3": {"arch": MESH_QWEN[0], "layers": MESH_QWEN[1], "tokens": MESH_QWEN[2],
                      "opt": MESH_OPT, "one_rank": q0["one_rank"], "step1": q0["step1"],
                      "step2": q0["step2"], "elastic": q0["elastic"],
                      "control_half_batch": q0.get("control_half_batch"),
                      "timeline": q0["timeline"],
                      "launches": [r["launches"] for r in qwen],
                      "step1_ranks": [{k: r["step1"][k] for k in (
                          "collectives", "bytes", "kinds", "peak_gb")} for r in qwen],
                      "peak_gb": [r["peak_gb"] for r in qwen],
                      "staged_bytes": [r["step1"]["staged_bytes"] for r in qwen]},
            "llama4": {"arch": MESH_LLAMA[0], "layers": MESH_LLAMA[1],
                       "capacity_factor": lcfg.capacity_factor, "opt": MESH_OPT,
                       "one_rank": l0["one_rank"], "forward": l0["forward"], "step": l0["step"],
                       "control_half_batch": l0.get("control_half_batch"),
                       "timeline": l0["timeline"],
                       "peak_gb": [r["peak_gb"] for r in llama]},
            "shards": {arch: {"layers": MESH_TP_LAYERS, "tokens": MESH_TP_TOKENS,
                              "mesh": dict(zip(MESH_AXES, MESH_TP_SHAPE)), "opt": MESH_OPT,
                              "one_rank": recs[0]["one_rank"], "step": recs[0]["step"],
                              "launches": [r["launches"] for r in recs],
                              "calls": [r["calls"] for r in recs],
                              "routes": [r["routes"] for r in recs],
                              "peak_gb": [r["peak_gb"] for r in recs]}
                       for arch, recs in tp.items()},
            "serve": serve_line, "nccl_world_1": nccl, "b9_int8": b9,
            "failures": failures, "lm_mesh_phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"lm_mesh": line}), flush=True)
    if failures:
        raise RuntimeError(f"lm_mesh: {failures}")
    entry = {"name": "dispatch_gather_int8", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/moe_gather.cu",
             "replaces": LM_KERNEL_REPLACES["dispatch_gather"],
             "launched_in": "the MoE a2a island's send buffer under a2a_int8 (lm_mesh: llama4-scout "
                     "over 4 ranks)", **{k: b9[k] for k in (
                         "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "shape", "exact")},
             "launches_in_the_step": b9_step, "library": "index_select (no mask, no int8)"}
    return line, entry


def main() -> int:
    # Before torch touches the card: kimi-k2's float32 run fills it to within
    # a few GB, where the caching allocator's split blocks would not fit.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # cuBLAS's setting for deterministic algorithms (the lm_train checkpoint check).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    lm_launches, captured, lm_routes, at_shapes = lm_phase(torch, dev, card.splitlines()[0])
    lm_kernels = lm_kernel_entries(torch, ops, ref, fa, ssd, captured, lm_launches, lm_routes,
                                   at_shapes)
    lm_kernels.append(moe_gather_entry(torch, ops, ref, captured, lm_launches, at_shapes))
    del captured
    torch.cuda.empty_cache()
    print(json.dumps({"lm_cli": lm_cli_runs(torch, ops)}), flush=True)
    print(json.dumps({"lm_kernel_sweep": lm_kernel_sweep(torch, ops, ref, fa, ssd, dev)}),
          flush=True)
    print(json.dumps({"moe_gather_sweep": moe_gather_sweep(torch, ops, ref, dev)}), flush=True)
    long_attn = long_prefill_attention(torch, ops, fa, dev)
    torch.cuda.empty_cache()
    print(json.dumps({"lm_long_prefill_attention": long_attn,
                      "lm_phase_s": time.perf_counter() - t_lm}), flush=True)

    # -- LM training: three models at full width, the CLI and the example --
    t_train = time.perf_counter()
    _, train_per_step = lm_train_phase(torch, dev, card.splitlines()[0])
    for entry in lm_kernels:
        if entry["name"] in train_per_step:
            entry["train_launches_per_step"] = train_per_step[entry["name"]]
            entry["train_backward"] = "the plain version's VJP (kernels/ops.py)"
    print(json.dumps({"lm_train_cli": train_cli_runs(torch, ops),
                      "lm_train_phase_s": time.perf_counter() - t_train}), flush=True)
    torch.cuda.empty_cache()

    # -- LM over a mesh of 4 ranks on this card, the serve CLI over 2, NCCL --
    mesh_line, b9_int8 = lm_mesh_phase(torch, np, ops, ref, dev, card.splitlines()[0])
    lm_kernels.append(b9_int8)
    dg = next(e for e in lm_kernels if e["name"] == "dispatch_gather")
    dg["int8"]["launches"] = b9_int8["launches"]
    dg["int8"]["launched_in"] = b9_int8["launched_in"]
    torch.cuda.empty_cache()
    # The LM dry run: lm_mesh's step predicted, production cells, the scale-out.
    lm_dryrun_phase(torch, ops, mesh_line, card.splitlines()[0])
    # B7, B8 and B9 at the float32 training forward's shapes.
    for name, sub in train_shape_entries(torch, ops, ref, dev).items():
        next(e for e in lm_kernels if e["name"] == name)["at_training_shape"] = sub
    torch.cuda.empty_cache()

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

    # The stream engine at full width: DDC(DDCConfig(backend="stream")).fit,
    # rounds of ingest / refresh / query, TTL expiry, its six checks.
    print(json.dumps({"stream_full_width": stream_full_width(
        torch, np, ddc, ops, spatial, dev, eps, pts, card.splitlines()[0])}), flush=True)
    torch.cuda.empty_cache()

    # The dist engine at full width beside its stream twin, equal after
    # every refresh; its tree, reduced run, BENCH_serve.json's rows and the
    # serve entry point.
    dist_line = dist_full_width(torch, np, ddc, ops, spatial, dev, eps, pts,
                                card.splitlines()[0])
    print(json.dumps({"dist_full_width": dist_line}), flush=True)
    torch.cuda.empty_cache()

    # The tree of aggregators at 64 shards (both trees == flat after every
    # refresh, BENCH_hierarchy.json's rows), then cluster tracking at full
    # width (flat == tree == resumed == plain tracker states).
    hier_line, node_b5 = hierarchy_full_width(torch, np, ddc, ops, spatial, dev,
                                              card.splitlines()[0])
    print(json.dumps({"hierarchy_full_width": hier_line}), flush=True)
    torch.cuda.empty_cache()
    track_line, track_b5 = tracking_full_width(torch, np, ddc, ops, spatial, dev,
                                               card.splitlines()[0])
    print(json.dumps({"tracking_full_width": track_line}), flush=True)
    torch.cuda.empty_cache()
    # DDC across 8 rank processes on this card, curation and the dry run.
    ranks_line, ranks_launches = ranks_full_width(torch, np, ddc, ops, dev, eps, pts,
                                                  card.splitlines()[0])
    print(json.dumps({"ranks_full_width": ranks_line}), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"curation": curation_phase(torch, np, ddc, ops, dev,
                                                 card.splitlines()[0])}), flush=True)
    torch.cuda.empty_cache()
    dry_line, b5_dryrun = dryrun_phase(torch, ops, ref, dev, card.splitlines()[0])
    print(json.dumps({"dryrun_ddc": dry_line}), flush=True)
    torch.cuda.empty_cache()
    # B5's rectangular form at the shapes these two paths give it.
    b5 = next(e for e in kernels if e["name"] == "cross_min_d2")
    b5["at_tracker_shape"] = shape_timing(torch, ops, ref, track_b5, floor_ms)
    b5["at_node_fold_shape"] = {name: shape_timing(torch, ops, ref, args, floor_ms)
                                for name, args in node_b5.items()}
    b5_square = next(e for e in kernels if e["name"] == "contour_min_d2")
    b5_square["at_512_lane_fold"] = b5_dryrun
    for entry in kernels:
        if entry["name"] in DIST_PATH_KERNELS:
            entry["dist_launches"] = dist_line["main_path_launches"].get(entry["name"], 0)
        if entry["name"] in ranks_launches:
            entry["ranks_launches"] = ranks_launches[entry["name"]]
    print(json.dumps({"kernels": kernels + lm_kernels}), flush=True)

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
