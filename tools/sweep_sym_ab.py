#!/usr/bin/env python3
"""Hold and time DBSCAN's pair kernels in turns on one card: the
neighbour counts and the min-label sweeps that test each unordered pair
once (``csrc/pair_sweep.cu``, and any other versions of that source) and,
given ``--parent DIR``, those of an older tree: the counts of its
``csrc/pairwise_dist.cu`` (one thread a row, column splits, a second pass:
``v1``) and the sweeps of its ``csrc/min_label.cu`` (``parent``), on the
same inputs.

    python3 tools/sweep_sym_ab.py [--paths] [--parent DIR] [OTHER.cu ...]

DIR is the root of that tree, for example ``git archive`` of an older
commit unpacked into a directory that ``.gitignore`` lists.  Needs a CUDA
card and nvcc; imports nothing of JAX.  Every other source must export
``pair_sweep.cu``'s four C entry points with the committed signatures;
each runs through the committed wrappers (``pairwise_dist.neighbor_count``
and the rest: the output's start value, the checks), as do the older
tree's sweeps.  The older tree's counts run through the wrappers below,
as that tree called them.  Each source is built with the package's nvcc
flags plus ``-Xptxas -v`` (registers, shared memory and spills per kernel
are printed, and the blocks of 256 threads an SM holds by registers).
Then every version is held bit for bit against the plain version, and two
launches against each other, on small cases (n = 1, ragged n, all rows
masked, no core point, duplicate points, labels above 2^30, coordinates
beyond the fold's bound, bt 64 / 96 / 128 / 512) and on lane 0 of
chip_smoke.py's full-width run (make_d2 at 262,144 points, seed 1, the
first 32,768; eps 0.015805, the ninth of its eps search; the dense path's
converged labels, and the sparse path's initial labels on the
Morton-sorted points with bt 512); then timed there in the order A, B,
..., v1, v1, ..., B, A.  Times are device time per call (CUDA events,
calls queued behind a spin kernel, median of the batches).

``--paths`` also drives chip_smoke.py's full-width default (block-sparse)
and dense paths (``make_ddc_fn``, 8 lanes, sync) with the committed
kernels and, given ``--parent``, with the older counts swapped into
``pairwise_dist``'s two count wrappers, in the order new, v1, v1, new:
each a warm-up run, then one run under torch.profiler (device time summed
over every kernel, the counts' and the sweeps' own shares, wall time),
the outputs of all runs bit-identical.
"""
from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FULL_N, LANES, BT = 262_144, 8, 512
EPS = 0.03 * math.sqrt(2048 / FULL_N) * 1.25 ** 8  # chip_smoke's ninth eps
SPIN_CYCLES = 20_000_000
CSRC = "src/repro_torch/kernels/csrc"
COUNTS = ("neighbor_count", "neighbor_count_sparse")
SWEEPS = ("min_label_sweep", "min_label_sweep_sparse")
# The count kernels' names, new and older, as profiles show them.
COUNT_KERNELS = ("neighbor_count_", "count_kernel", "count_sparse_kernel", "sum_splits")
V1_TILE, V1_TARGET_BLOCKS = 256, 1024  # the older counts' tiles and grid target


def regs_blocks(line: str) -> int | None:
    """Blocks of 256 threads an SM holds by registers, from a ptxas line."""
    words = line.replace(",", " ").split()
    if "registers" not in words:
        return None
    regs = int(words[words.index("registers") - 1])
    per_warp = -(-regs * 32 // 256) * 256
    return 65536 // (per_warp * 8)


def median_ms(torch, fn, reps=20, per=10):
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


def build(sources: dict) -> dict | None:
    """Build every source with ``-Xptxas -v``, all nvcc processes started
    together; print each one's registers, spills and blocks per SM."""
    from repro_torch.kernels import _build

    out_dir = Path(tempfile.mkdtemp())
    procs = {n: subprocess.Popen([_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC),
                                  "-Xptxas", "-v", "-o", str(out_dir / f"{n}.so"), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, src in sources.items()}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return None
        lines = [line.strip() for line in log.splitlines()
                 if "Compiling entry" in line or "registers" in line or "spill" in line
                 or "Warning" in line]
        print(json.dumps({"source": str(sources[n]), "ptxas": lines,
                          "blocks_per_sm_by_registers": [b for b in map(regs_blocks, lines)
                                                         if b is not None]}), flush=True)
        libs[n] = ctypes.CDLL(str(out_dir / f"{n}.so"))
    return libs


def through_wrappers(pd, lib, funcs) -> dict:
    """The committed wrappers of ``funcs`` on another build of
    ``pair_sweep.cu``'s entry points (``lib``, declared already)."""
    def one(wrapper):
        def run(*args, **kw):
            committed = pd._sym_lib
            pd._sym_lib = lambda: lib
            try:
                return wrapper(*args, **kw)
            finally:
                pd._sym_lib = committed
        return run
    return {f: one(getattr(pd, f)) for f in funcs}


def parent_sweeps(pd, lib) -> dict:
    """The sweeps of an older ``csrc/min_label.cu`` (built as ``lib``), whose
    C entries have the committed signatures."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.min_label_sweep_launch.argtypes = [P, P, P, P, I, F, P, P]
    lib.min_label_sweep_sparse_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, F, P, P]
    return through_wrappers(pd, lib, SWEEPS)


def v1_counts(torch, pd, lib) -> dict:
    """The two counts of an older ``csrc/pairwise_dist.cu`` (built as
    ``lib``), called as that tree's wrappers called them: the columns (or
    each row tile's column-tile list) split so that about 1,024 blocks
    run, with an (splits, n) scratch and a second pass."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.neighbor_count_launch.argtypes = [P, P, I, F, I, P, P, P]
    lib.neighbor_count_sparse_launch.argtypes = [P, P, P, P, I, I, I, F, I, P, P, P]

    def launch(fn, x, *args):
        code = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
        if code:
            raise RuntimeError(f"the older count failed with CUDA error {code}")

    def scratch(x, s):
        n = x.shape[0]
        return torch.empty((s, n), dtype=torch.int32, device=x.device) if s > 1 else None

    def dense(x, m, eps):
        n = x.shape[0]
        out = torch.empty((n,), dtype=torch.int32, device=x.device)
        tiles = -(-n // V1_TILE)
        s = max(1, min(tiles, -(-V1_TARGET_BLOCKS // tiles)))
        part = scratch(x, s)
        launch(lib.neighbor_count_launch, x, x.data_ptr(), m.data_ptr(), n,
               pd.ref.eps_sq_f32(eps), s, None if part is None else part.data_ptr(),
               out.data_ptr())
        return out

    def sparse(x, m, eps, pairs, *, bt):
        n = x.shape[0]
        rpb = max(r for r in range(32, V1_TILE + 1, 32) if bt % r == 0)
        s = max(1, min(n // bt, -(-V1_TARGET_BLOCKS // (n // rpb))))
        out = torch.empty((n,), dtype=torch.int32, device=x.device)
        part = scratch(x, s)
        launch(lib.neighbor_count_sparse_launch, x, x.data_ptr(), m.data_ptr(),
               pairs.row_ptr.data_ptr(), pairs.cols.data_ptr(), n, bt, rpb,
               pd.ref.eps_sq_f32(eps), s, None if part is None else part.data_ptr(),
               out.data_ptr())
        return out

    return {"neighbor_count": dense, "neighbor_count_sparse": sparse}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_sym_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import dbscan
    from repro_torch.data import spatial
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import pairwise_dist as pd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    args = [a for a in sys.argv[1:] if a != "--paths"]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1])
        del args[i:i + 2]
    sources = {"committed": _build.CSRC / "pair_sweep.cu"}
    sources.update({Path(f).stem: Path(f) for f in args})
    if parent is not None:
        sources["v1"] = parent / CSRC / "pairwise_dist.cu"
        sources["parent"] = parent / CSRC / "min_label.cu"
    libs = build(sources)
    if libs is None:
        return 1
    versions = {}
    for n, lib in libs.items():
        if n == "v1":
            versions[n] = v1_counts(torch, pd, lib)
        elif n == "parent":
            versions[n] = parent_sweeps(pd, lib)
        else:
            versions[n] = through_wrappers(pd, pd.bind_sym(lib), COUNTS + SWEEPS)
    dev = torch.device("cuda")
    failed = False

    def hold(case, func, args, kw, want):
        nonlocal failed
        row = {}
        for n, fns in versions.items():
            if func not in fns:
                continue
            got = fns[func](*args, **kw)
            row[n] = {"exact": bool(torch.equal(got, want)),
                      "identical": bool(torch.equal(got, fns[func](*args, **kw)))}
            failed |= not (row[n]["exact"] and row[n]["identical"])
        print(json.dumps({"case": case, "func": func, **row}), flush=True)

    rng = torch.Generator(device="cpu").manual_seed(0)
    for n, eps, kind in ((1, 0.1, "normal"), (255, 0.3, "normal"), (1000, 0.1, "masked"),
                         (4097, 0.05, "no_core"), (2048, 0.05, "duplicates"),
                         (600, 0.3, "big"), (300, 100.0, "all_big"),
                         (3000, 1e20, "overflow"), (32768, 0.02, "normal")):
        x = torch.randn((n, 2), generator=rng)
        m = torch.rand(n, generator=rng) > (1.1 if kind == "masked" else 0.3)
        lab = torch.randint(0, n, (n,), generator=rng, dtype=torch.int32)
        lab[::7] = ref.SENTINEL
        core = torch.rand(n, generator=rng) > (1.1 if kind == "no_core" else 0.5)
        if kind == "duplicates":
            x = x[:n // 16].repeat_interleave(16, dim=0)
        elif kind == "big":
            lab = torch.randint(0, 2**31 - 1, (n,), generator=rng, dtype=torch.int32)
        elif kind == "all_big":
            lab = torch.randint(ref.SENTINEL + 1, 2**31 - 1, (n,), generator=rng,
                                dtype=torch.int32)
            m[:], core[:] = True, True
        elif kind == "overflow":
            x = x * 1e17
            x[3] = torch.tensor([1.35e19, 0.0])
            lab[3], m[3], core[3] = -1, True, True
        x, m, lab, core = x.to(dev), m.to(dev), lab.to(dev), core.to(dev)
        case = {"dense": n, "eps": eps, "kind": kind}
        hold(case, "neighbor_count", (x, m, eps), {}, ref.neighbor_count(x, m, eps))
        hold(case, "min_label_sweep", (x, m, lab, core, eps), {},
             ref.min_label_sweep(x, m, lab, core, eps))
    for n, bt, eps in ((4096, 64, 0.02), (4096, 128, 0.03), (8192, 512, 0.01), (2048, 96, 0.05)):
        pts = torch.as_tensor(spatial.make_clustered(n, seed=n + bt), device=dev)
        m = torch.rand(n, generator=rng).to(dev) > 0.2
        sp, sm, _ = dbscan.spatial_sort(dbscan.center_points(pts, m), m, bt)
        sp, sm = sp.contiguous(), sm.contiguous()
        npad = sp.shape[0]
        lab = torch.randint(0, npad, (npad,), generator=rng, dtype=torch.int32).to(dev)
        core = torch.rand(npad, generator=rng).to(dev) > 0.5
        pairs = ops.build_tile_pairs(sp, sm, eps, bt=bt)
        case = {"sparse": npad, "bt": bt, "eps": eps, "n_active": int(pairs.n_active)}
        hold(case, "neighbor_count_sparse", (sp, sm, eps, pairs), {"bt": bt},
             ref.neighbor_count(sp, sm, eps))
        hold(case, "min_label_sweep_sparse", (sp, sm, lab, core, eps, pairs), {"bt": bt},
             ref.min_label_sweep(sp, sm, lab, core, eps))

    # Lane 0 of the full-width run, as chip_smoke.py's kernels line takes it.
    per = FULL_N // LANES
    pts = spatial.make_d2(FULL_N, seed=1)
    x0 = torch.as_tensor(pts[:per], device=dev)
    m0 = torch.ones(per, dtype=torch.bool, device=dev)
    xc = dbscan.center_points(x0, m0).contiguous()
    res = dbscan.dbscan(x0, m0, EPS, 4, block_sparse="never")
    lab_in = torch.where(res.core, res.labels, dbscan.SENTINEL).to(torch.int32)
    sp, sm, order = dbscan.spatial_sort(xc, m0, BT)
    sp, sm = sp.contiguous(), sm.contiguous()
    pairs = ops.build_tile_pairs(sp, sm, EPS, bt=BT)
    core_s = res.core[order].contiguous()
    lab_s = torch.where(core_s, torch.arange(per, dtype=torch.int32, device=dev),
                        dbscan.SENTINEL).to(torch.int32)
    runs = {
        "neighbor_count": ((xc, m0, EPS), {}, ref.neighbor_count(xc, m0, EPS)),
        "neighbor_count_sparse": ((sp, sm, EPS, pairs), {"bt": BT},
                                  ref.neighbor_count_sparse(sp, sm, EPS, pairs.rows,
                                                            pairs.cols, pairs.flags, BT)),
        "min_label_sweep": ((xc, m0, lab_in, res.core, EPS), {},
                            ref.min_label_sweep(xc, m0, lab_in, res.core, EPS)),
        "min_label_sweep_sparse": ((sp, sm, lab_s, core_s, EPS, pairs), {"bt": BT},
                                   ref.min_label_sweep_sparse(sp, sm, lab_s, core_s, EPS,
                                                              pairs.rows, pairs.cols,
                                                              pairs.flags, BT))}
    info = {"n": per, "eps": EPS, "n_active": int(pairs.n_active), "n_up": int(pairs.n_up),
            "items_dense": pd.sym_work_items(per),
            "items_sparse": pd.sym_work_items(per, pairs, bt=BT)}
    for func, (fargs, kw, want) in runs.items():
        hold({"lane0": func, **info}, func, fargs, kw, want)
        names = [n for n, fns in versions.items() if func in fns]
        times = {n: [] for n in names}
        for n in names + names[::-1]:
            times[n].append(median_ms(torch, lambda: versions[n][func](*fargs, **kw)))
        print(json.dumps({"lane0_ms": func, **times}), flush=True)
    if "--paths" in sys.argv:
        failed |= not full_width_paths(torch, pts, EPS, versions.get("v1"))
    print(json.dumps({"ok": not failed}), flush=True)
    return 1 if failed else 0


def full_width_paths(torch, pts, eps, old) -> bool:
    """The default and dense full-width paths on the committed kernels and,
    given ``old`` (``v1_counts``), on those counts, in the order new, v1,
    v1, new; True when every run of a path gives the same outputs."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ddc
    from repro_torch.kernels import pairwise_dist as pd

    new = {f: getattr(pd, f) for f in COUNTS}
    mask = np.ones(len(pts), bool)
    same = True
    for path, block_sparse in (("default", "auto"), ("dense", "never")):
        cfg = ddc.DDCConfig(eps=eps, min_pts=4, schedule="sync", block_sparse=block_sparse)
        first = None
        for kind in ("new", "v1", "v1", "new") if old else ("new",):
            for name, fn in (new if kind == "new" else old).items():
                setattr(pd, name, fn)
            run = ddc.make_ddc_fn(cfg, LANES, device="cuda")
            run(pts, mask)
            torch.cuda.synchronize()
            trace: dict = {}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = run(pts, mask, trace)
                torch.cuda.synchronize()
            device_ms = count_ms = sweep_ms = 0.0
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(e, "self_device_time_total", None)
                ms = (e.self_cuda_time_total if us is None else us) / 1e3
                device_ms += ms
                if any(k in e.key for k in COUNT_KERNELS):
                    count_ms += ms
                elif "min_label" in e.key:
                    sweep_ms += ms
            flat = [out[0], *out[1], out[2]]
            if first is None:
                first = flat
            same &= all(torch.equal(a, b) for a, b in zip(first, flat))
            print(json.dumps({"path": path, "counts": kind, "device_ms": device_ms,
                              "count_kernels_ms": count_ms, "sweep_kernels_ms": sweep_ms,
                              "phase1_s": trace["phase1_s"], "phase2_s": trace["phase2_s"],
                              "outputs_identical": same}), flush=True)
    for name, fn in new.items():
        setattr(pd, name, fn)
    return same


if __name__ == "__main__":
    sys.exit(main())
