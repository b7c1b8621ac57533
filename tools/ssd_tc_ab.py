#!/usr/bin/env python3
"""Time the SSD scan's two routes in turns on one card: the tensor-core
kernel (``csrc/ssd_scan_tc.cu``, and any other versions of that source)
against the CUDA-core kernel (``csrc/ssd_scan.cu``) on the same bf16
inputs.

    python3 tools/ssd_tc_ab.py [OTHER.cu ...]

Needs a CUDA card and nvcc; imports nothing of JAX.  Every tensor-core
source must export ``ssd_scan_tc_launch`` with the committed signature.
Each is built with the package's nvcc flags plus ``-Xptxas -v`` (its
registers, spills and warnings are printed) and held, with the CUDA-core
kernel, to chip_smoke.py's ``bf16_tol`` against the plain version on
eight shapes (ragged l, l < 64, l = 1, b > 1, broadcast c, the Mamba
layer's strided x) and on mamba2-1.3b's prefill shape, with two launches
bit-identical; then timed at that shape (b 4, l 2,048, h 64, dh 64, ds 128,
bf16; x a slice of the conv output, c broadcast over the heads, as
``layers._mamba_ssd_inputs`` hands them over) in the order A, B, ..., simt,
simt, ..., B, A, and at l 32,768 (one sequence).  Times are device time
per call (CUDA events, calls queued behind a spin kernel, median of the
batches).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

H, DH, DS = 64, 64, 128  # mamba2-1.3b's SSM heads
CASES = [  # b, l, h, layout ("mamba": strided x, broadcast c; "dense": contiguous)
    (1, 64, 2, "dense"), (1, 333, 4, "dense"), (1, 50, 2, "dense"), (1, 1, 2, "dense"),
    (2, 200, 3, "dense"), (2, 130, 4, "mamba"), (1, 1000, 2, "mamba"), (3, 64, 1, "mamba"),
]
SPIN_CYCLES = 20_000_000


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_tc_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as ssd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sources = {"committed": _build.CSRC / "ssd_scan_tc.cu"}
    sources.update({Path(f).stem: Path(f) for f in sys.argv[1:]})
    out_dir = Path(tempfile.mkdtemp())
    procs = {n: subprocess.Popen([_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC),
                                  "-Xptxas", "-v", "-o", str(out_dir / f"{n}.so"), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, src in sources.items()}
    launchers = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        print(json.dumps({"source": str(sources[n]), "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Warning" in line or "C75" in line]}),
            flush=True)
        fn = ctypes.CDLL(str(out_dir / f"{n}.so")).ssd_scan_tc_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 5 + [i] * 3 + ([ll] * 3 + [i] * 2) * 3 + [ll] * 3 + [p]
        fn.restype = i
        launchers[n] = fn

    def run(n, x, a, b, c):
        if n == "simt":
            return ssd._launch("simt", x, a, b, c)
        bsz, l, h, dh = x.shape
        y = torch.empty((bsz, l, h, dh), dtype=x.dtype, device=x.device)
        args = [v for name, t in (("x", x), ("b", b), ("c", c)) for v in ssd._tma_strides(name, t)]
        code = launchers[n](x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                            bsz, l, h, *args, *a.stride(), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{n}: launch error {code}")
        return y

    def outside_bf16_tol(got, want) -> int:
        g, w = got.double(), want.double()
        return int(((g - w).abs() > 2.0 ** -12 * float(w.abs().max()) + 2.0 ** -7 * w.abs())
                   .sum())

    def median_ms(fn, reps=10, per=5):
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

    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(bsz, l, h, layout):
        """The Mamba layer's SSD inputs from a seeded conv output: x and c
        silu'd, b = silu(.) * dt, a = -exp(a_log) * dt (about -0.7 a step)."""
        if layout == "dense":
            x, b, c = (torch.randn(s, generator=g, device="cuda").bfloat16()
                       for s in ((bsz, l, h, DH), (bsz, l, h, DS), (bsz, l, h, DS)))
            a = -0.1 * torch.randn((bsz, l, h), generator=g, device="cuda").abs()
            return x, a, b, c
        xbc = torch.nn.functional.silu(
            torch.randn((bsz, l, h * DH + 2 * DS), generator=g, device="cuda")).bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn((bsz, l, h), generator=g, device="cuda") - 1.0).bfloat16()
        a_log = torch.rand((h,), generator=g, device="cuda") * 0.5
        x = xbc[..., :h * DH].reshape(bsz, l, h, DH)
        b = xbc[..., h * DH:h * DH + DS][:, :, None, :].expand(bsz, l, h, DS) * dt[..., None]
        c = xbc[..., h * DH + DS:][:, :, None, :].expand(bsz, l, h, DS)
        return x, -torch.exp(a_log)[None, None, :] * dt, b, c

    names = list(launchers) + ["simt"]
    failed = False
    for case in CASES:
        x, a, b, c = inputs(*case)
        want = ref.ssd_scan(x, a, b, c)
        row = {}
        for n in names:
            got = run(n, x, a, b, c)
            row[n] = {"outside_tol": outside_bf16_tol(got, want),
                      "max_abs_err": float((got.double() - want.double()).abs().max()),
                      "identical": bool(torch.equal(got, run(n, x, a, b, c)))}
            failed |= row[n]["outside_tol"] > 0 or not row[n]["identical"]
        print(json.dumps({"case": list(case), **row}), flush=True)
    x, a, b, c = inputs(4, 2048, H, "mamba")
    want = ref.ssd_scan_chunked(x, a, b, c, chunk=128)
    held = {n: outside_bf16_tol(run(n, x, a, b, c), want) for n in names}
    failed |= any(held.values())
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(median_ms(lambda: run(n, x, a, b, c)))
    print(json.dumps({"mamba2_prefill_outside_tol": held, "mamba2_prefill_ms": times}),
          flush=True)
    del x, a, b, c, want
    x, a, b, c = inputs(1, 32768, H, "mamba")
    long = {n: median_ms(lambda: run(n, x, a, b, c), 3, 2) for n in names}
    print(json.dumps({"l_32k_ms": long}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
