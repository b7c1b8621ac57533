#!/usr/bin/env python3
"""Hold and time the phase-2 contour distance (B5, ``csrc/contour_dist.cu``:
its square and rectangular forms) and K-Means' distance matrix (B6,
``csrc/pairwise_dist.cu``) in turns on one card, beside the launch floor
(``csrc/launch_floor.cu``, an empty kernel); given ``--parent DIR``, also
the first port's versions of both sources from an older tree (``v1``: one
block per row slot and column group, FMA-free; one thread per output
element), on the same inputs.

    python3 tools/phase2_ab.py [--paths] [--parent DIR] [OTHER[:NAME=VALUE,...] ...]

OTHER is another version of ``contour_dist.cu`` or ``pairwise_dist.cu`` (a
path, or the name of a committed source), with ``constexpr int`` constants
set anew where ``NAME=VALUE`` pairs follow (``contour_dist.cu:kThreads=512``);
it is held to the committed plain versions and timed beside the others.
A version whose name has ``diag`` as one of its ``_``-separated words
(``diag_store_only``, ``b5_diag_nocompute``) is a diagnostic that leaves
out part of the work on purpose: its exactness is printed like every
other's, but it does not fail the run.  The last lines give each
version's verdict over every case (``{"exact": {...}}``) and whether every
version that is not a diagnostic was exact and identical (``{"ok": ...}``).
DIR is the root of that tree, for example ``git archive`` of an older
commit unpacked into a directory that ``.gitignore`` lists.  Needs a CUDA
card and nvcc; imports nothing of JAX.  Each source is built with the
package's nvcc flags plus ``-Xptxas -v`` (registers, shared memory and
spills per kernel printed).  Every version is held bit for bit, and two
launches against each other: the committed B5 and B6 against the plain
versions (``ref.contour_min_d2``, ``ref.cross_min_d2``,
``ref.pairwise_dist_sq``), the first port's B5 against its own FMA-free
plain form (dx·dx + dy·dy, rounded twice) and its B6 against
``ref.pairwise_dist_sq``, on small cases (every slot empty, one valid
slot, full slots, ragged counts, v 8 / 128 / 2048; k 1, 3, 4, 7, 8, 16,
128, 256, 300, 4,100, ragged n) and on chip_smoke.py's full-width inputs (make_d2 at 262,144
points, seed 1, eps 0.015805, 8 lanes, sync: the stacked 256-slot batch;
the delta merge's 96 rows of lanes 1, 3, 6 from a second draw, seed 2,
against it; lane 0 of K-Means' path and its 8 centres).  Then each is
timed there in the order floor, new, v1, v1, new, floor: device time per
call (CUDA events, 10 calls queued behind a spin kernel, the median of 20
batches), as chip_smoke.py's kernels line times them.

``--paths`` also drives the full-width K-Means (k 8, async) and async
DBSCAN paths with the committed kernels and, given ``--parent``, with
the first port's B5 and B6 swapped into the wrappers, in the order new,
v1, v1, new: a warm-up run each, then one run under torch.profiler
(device time over every kernel, B5's and B6's shares, wall time).
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from sweep_sym_ab import EPS, FULL_N, LANES, build, median_ms

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = "src/repro_torch/kernels/csrc"
DIRTY = (1, 3, 6)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"contour_min_d2_launch": [_P, _P, _P, _I, _I, _P, _P],
              "cross_min_d2_launch": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P],
              "pairwise_dist_sq_launch": [_P, _P, _I, _I, _P, _P],
              "empty_launch": [_P]}
B5_KERNELS, B6_KERNELS = ("contour_min_kernel",), ("dist_kernel", "dist_rows_kernel")


def bind(lib):
    for name, args in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _I
    return lib


def callers(torch, lib) -> dict:
    """The library's entry points as functions of tensors (outputs
    allocated here, launched on the current stream)."""
    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(code):
        if code:
            raise RuntimeError(f"CUDA error {code}")

    fns = {}
    if hasattr(lib, "contour_min_d2_launch"):
        def square(c, n, v):
            out = torch.empty((c.shape[0], c.shape[0]), dtype=torch.float32, device=c.device)
            check(lib.contour_min_d2_launch(c.data_ptr(), n.data_ptr(), v.data_ptr(),
                                            c.shape[0], c.shape[1], out.data_ptr(), stream()))
            return out
        fns["contour_min_d2"] = square
    if hasattr(lib, "cross_min_d2_launch"):
        def rect(ca, na, va, cb, nb, vb):
            out = torch.empty((ca.shape[0], cb.shape[0]), dtype=torch.float32,
                              device=ca.device)
            check(lib.cross_min_d2_launch(ca.data_ptr(), na.data_ptr(), va.data_ptr(),
                                          ca.shape[0], cb.data_ptr(), nb.data_ptr(),
                                          vb.data_ptr(), cb.shape[0], ca.shape[1],
                                          out.data_ptr(), stream()))
            return out
        fns["cross_min_d2"] = rect
    if hasattr(lib, "pairwise_dist_sq_launch"):
        def dist(x, y):
            out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32, device=x.device)
            check(lib.pairwise_dist_sq_launch(x.data_ptr(), y.data_ptr(), x.shape[0],
                                              y.shape[0], out.data_ptr(), stream()))
            return out
        fns["pairwise_dist_sq"] = dist
    if hasattr(lib, "empty_launch"):
        fns["empty"] = lambda: check(lib.empty_launch(stream()))
    return fns


def other_source(spec: str, csrc: Path) -> tuple[str, Path]:
    """(name, path) of an OTHER argument: the file, or a copy of it with
    the listed ``constexpr int`` constants set anew."""
    path, _, sets = spec.partition(":")
    src = Path(path) if Path(path).exists() else csrc / path
    if not sets:
        return src.stem, src
    text = src.read_text()
    for pair in sets.split(","):
        name, value = pair.split("=")
        text, hits = re.subn(rf"constexpr int {name} = [0-9]+;", f"constexpr int {name} = {value};",
                             text)
        if hits != 1:
            raise SystemExit(f"{spec}: no single constexpr int {name} in {src}")
    out = Path(tempfile.mkdtemp()) / src.name
    out.write_text(text)
    return re.sub(r"[^A-Za-z0-9]+", "_", f"{src.stem}_{sets}"), out


def diagnostic(name: str) -> bool:
    """A version that skips work on purpose and so cannot be exact."""
    return "diag" in name.split("_")


def fma_free_min_d2(torch, c, n, val):
    """The first port's plain contour distance: dx·dx + dy·dy rounded twice
    (eager PyTorch runs each product and the sum as its own kernel)."""
    m, v, _ = c.shape
    vv = (torch.arange(v, device=c.device)[None, :] < n[:, None]) & val[:, None]
    out = torch.empty((m, m), dtype=torch.float32, device=c.device)
    for i in range(m):
        d = c[i][:, None, None, :] - c[None]                       # (v, m, v, 2)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = torch.where(vv[i][:, None, None] & vv[None], d2, 1e30)
        out[i] = d2.amin(dim=(0, 2))
    return out


def contour_case(torch, rng, m, v, kind, dev):
    c = torch.rand((m, v, 2), generator=rng)
    n = torch.randint(0, v + 1, (m,), generator=rng, dtype=torch.int32)
    val = torch.rand(m, generator=rng) > 0.25
    if kind == "invalid":
        val[:] = False
    elif kind == "one":
        val[:] = False
        val[m // 2], n[m // 2] = True, max(1, v // 3)
    elif kind == "full":
        n[:], val[:] = v, True
    elif kind == "ragged":
        n[0], n[-1] = v + 7, -3
        c[1] = c[0]
    return c.to(dev), n.to(dev), val.to(dev)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("phase2_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import ddc
    from repro_torch.data import spatial
    from repro_torch.kernels import _build, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    args = [a for a in sys.argv[1:] if a != "--paths"]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1])
        del args[i:i + 2]
    sources = {"contour_dist": _build.CSRC / "contour_dist.cu",
               "pairwise_dist": _build.CSRC / "pairwise_dist.cu",
               "launch_floor": _build.CSRC / "launch_floor.cu"}
    others = dict(other_source(a, _build.CSRC) for a in args)
    sources.update(others)
    if parent is not None:
        sources["v1_contour_dist"] = parent / CSRC / "contour_dist.cu"
        sources["v1_pairwise_dist"] = parent / CSRC / "pairwise_dist.cu"
    libs = build(sources)
    if libs is None:
        return 1
    fns = {n: callers(torch, bind(lib)) for n, lib in libs.items()}
    new = {**fns["contour_dist"], **fns["pairwise_dist"]}
    versions = {"new": new, **{n: fns[n] for n in others}}
    if parent is not None:
        versions["v1"] = {**fns["v1_contour_dist"], **fns["v1_pairwise_dist"]}
    empty = fns["launch_floor"]["empty"]
    plain = {"new": {"contour_min_d2": ref.contour_min_d2, "cross_min_d2": ref.cross_min_d2,
                     "pairwise_dist_sq": ref.pairwise_dist_sq},
             "v1": {"contour_min_d2": lambda c, n, v: fma_free_min_d2(torch, c, n, v),
                    "pairwise_dist_sq": ref.pairwise_dist_sq}}
    dev = torch.device("cuda")
    verdict = {n: True for n in versions}

    def hold(case, func, fargs):
        row = {}
        for n, vfns in versions.items():
            if func not in vfns:
                continue
            got = vfns[func](*fargs)
            want = plain["v1" if n == "v1" else "new"][func](*fargs)
            row[n] = {"exact": bool(torch.equal(got, want)),
                      "identical": bool(torch.equal(got, vfns[func](*fargs)))}
            verdict[n] &= row[n]["exact"] and row[n]["identical"]
        print(json.dumps({"case": case, "func": func, **row}), flush=True)

    rng = torch.Generator(device="cpu").manual_seed(0)
    for m, v, kind in ((256, 128, "invalid"), (256, 128, "one"), (40, 128, "full"),
                       (64, 8, "ragged"), (17, 2048, "ragged"), (300, 16, "mixed"),
                       (256, 128, "mixed")):
        side = contour_case(torch, rng, m, v, kind, dev)
        hold({"m": m, "v": v, "kind": kind}, "contour_min_d2", side)
        rows = slice(0, m, 3)
        hold({"m": m, "v": v, "kind": kind, "rows": "every third"}, "cross_min_d2",
             (*(t[rows].contiguous() for t in side), *side))
    for n, k in ((1, 1), (1000, 7), (77, 4), (32768, 1), (32768, 3), (32768, 8), (32768, 16),
                 (300, 128), (4097, 300), (513, 256), (100, 4100)):
        x = torch.randn((n, 2), generator=rng).to(dev)
        y = torch.randn((k, 2), generator=rng).to(dev)
        hold({"n": n, "k": k}, "pairwise_dist_sq", (x, y))

    # chip_smoke.py's full-width inputs.
    mask = np.ones(FULL_N, bool)
    pts = spatial.make_d2(FULL_N, seed=1)
    cfg = ddc.DDCConfig(eps=EPS, min_pts=4, schedule="sync")
    traces = [{}, {}]
    ddc.make_ddc_fn(cfg, LANES, device="cuda")(pts, mask, traces[0])
    ddc.make_ddc_fn(cfg, LANES, device="cuda")(spatial.make_d2(FULL_N, seed=2), mask, traces[1])
    batch, other = traces[0]["batch"], traces[1]["batch"]
    new3 = ddc.stack_clustersets([ddc.lane_set(other if i in DIRTY else batch, i)
                                  for i in range(LANES)])
    c, v = cfg.max_clusters, cfg.max_verts
    ms = LANES * c
    side = (batch.contours.reshape(ms, v, 2).contiguous(), batch.counts.reshape(ms).contiguous(),
            batch.valid.reshape(ms).contiguous())
    side3 = (new3.contours.reshape(ms, v, 2).contiguous(), new3.counts.reshape(ms).contiguous(),
             new3.valid.reshape(ms).contiguous())
    rows = torch.cat([torch.arange(i * c, (i + 1) * c, device=dev) for i in DIRTY])
    dirty_rows = tuple(t[rows].contiguous() for t in side3)
    per = FULL_N // LANES
    x0 = torch.as_tensor(pts[:per], device=dev)
    km = ddc.make_ddc_fn(ddc.DDCConfig(eps=EPS, min_pts=4, local_algo="kmeans",
                                       schedule="async"), LANES, device="cuda")
    tkm: dict = {}
    km(pts, mask, tkm)
    cents = tkm["results"][0].centroids.contiguous()
    runs = {"contour_min_d2": side, "cross_min_d2": (*dirty_rows, *side3),
            "pairwise_dist_sq": (x0, cents)}
    info = {"valid_slots": int(side[2].sum()), "dirty_valid_slots": int(dirty_rows[2].sum()),
            "slots": ms, "v": v, "n": per, "k": int(cents.shape[0])}
    for func, fargs in runs.items():
        hold({"full_width": func, **info}, func, fargs)
        names = [n for n, vfns in versions.items() if func in vfns]
        times = {"floor": [], **{n: [] for n in names}}
        for n in ["floor", *names, *names[::-1], "floor"]:
            fn = empty if n == "floor" else (lambda n=n: versions[n][func](*fargs))
            times[n].append(median_ms(torch, fn))
        print(json.dumps({"full_width_ms": func, **times}), flush=True)
    if "--paths" in sys.argv:
        full_width_paths(torch, pts, mask, libs if parent is not None else None)
    print(json.dumps({"exact": verdict,
                      "diagnostics": [n for n in versions if diagnostic(n)]}), flush=True)
    ok = all(v for n, v in verdict.items() if not diagnostic(n))
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


def full_width_paths(torch, pts, mask, libs) -> None:
    """The K-Means and async DBSCAN full-width paths on the committed B5 and
    B6 and, given the first port's libraries, on those, in the order new,
    v1, v1, new.  The first port's B5 rounds twice, so its outputs may
    differ in a merge at the threshold: reported, not held."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ddc
    from repro_torch.kernels import contour_dist as cd
    from repro_torch.kernels import pairwise_dist as pd

    new = {cd: cd._lib, pd: pd._lib}
    old = None
    if libs is not None:
        old = {cd: functools.cache(lambda: libs["v1_contour_dist"]),
               pd: functools.cache(lambda: libs["v1_pairwise_dist"])}
        for lib in libs.values():
            for name in ("contour_dist_error_string", "pairwise_dist_error_string"):
                if hasattr(lib, name):
                    getattr(lib, name).argtypes = [_I]
                    getattr(lib, name).restype = ctypes.c_char_p
    for path, cfg in (("kmeans", ddc.DDCConfig(eps=EPS, min_pts=4, local_algo="kmeans",
                                               schedule="async")),
                      ("async", ddc.DDCConfig(eps=EPS, min_pts=4, schedule="async"))):
        first = None
        for kind in ("new", "v1", "v1", "new") if old else ("new",):
            for mod, fn in (new if kind == "new" else old).items():
                mod._lib = fn
            run = ddc.make_ddc_fn(cfg, LANES, device="cuda")
            run(pts, mask)
            torch.cuda.synchronize()
            trace: dict = {}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = run(pts, mask, trace)
                torch.cuda.synchronize()
            device_ms = b5_ms = b6_ms = 0.0
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(e, "self_device_time_total", None)
                t = (e.self_cuda_time_total if us is None else us) / 1e3
                device_ms += t
                if any(k in e.key for k in B5_KERNELS):
                    b5_ms += t
                elif any(k in e.key for k in B6_KERNELS):
                    b6_ms += t
            flat = [out[0], *out[1], out[2]]
            first = first or flat
            print(json.dumps({"path": path, "kernels": kind, "device_ms": device_ms,
                              "b5_ms": b5_ms, "b6_ms": b6_ms, "phase1_s": trace["phase1_s"],
                              "phase2_s": trace["phase2_s"],
                              "outputs_identical_to_first": all(
                                  torch.equal(a, b) for a, b in zip(first, flat))}),
                  flush=True)
    for mod, fn in new.items():
        mod._lib = fn


if __name__ == "__main__":
    sys.exit(main())
