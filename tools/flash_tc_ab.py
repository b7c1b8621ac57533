#!/usr/bin/env python3
"""Time the tensor-core flash attention (``csrc/flash_attention_tc.cu``)
against other versions of the same source, in turns on one card.

    python3 tools/flash_tc_ab.py OTHER.cu [OTHER.cu ...]

Needs a CUDA card and nvcc; imports nothing of JAX.  Every source must
export ``flash_attention_tc_launch`` with the committed signature.  Each is
built with the package's nvcc flags plus ``-Xptxas -v`` (its registers,
spills and warnings are printed), held on ten shapes (GQA, MQA,
non-causal, windowed, ragged, sq = 1, sq < 64, d 64 and 128) and on
qwen3-8b's prefill shape to chip_smoke.py's ``bf16_tol`` against the plain
version, with two launches bit-identical; then timed at qwen3-8b's prefill
shape (b 4, h 32, hkv 8, s 2,048, d 128, bf16, causal, gqa_qkv's strided
views) in the order A, B, ..., ..., B, A, beside SDPA, and at prefill_32k's
length (one sequence, one layer).  Times are device time per call (CUDA
events, 5 calls queued behind a spin kernel, median of 10 batches).
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

CASES = [  # b, h, hkv, sq, skv, d, causal, window
    (1, 2, 2, 128, 128, 128, True, None), (1, 2, 2, 128, 128, 64, True, None),
    (2, 8, 2, 256, 256, 128, True, None), (1, 4, 1, 300, 300, 64, True, None),
    (1, 4, 2, 100, 173, 128, True, 50), (1, 4, 2, 200, 333, 64, False, None),
    (2, 4, 4, 1, 77, 128, True, None), (1, 4, 4, 33, 70, 128, True, None),
    (1, 32, 8, 1000, 1000, 128, True, None), (1, 2, 2, 700, 700, 128, True, 100),
]
SPIN_CYCLES = 20_000_000


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_tc_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sources = {"committed": _build.CSRC / "flash_attention_tc.cu"}
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
        fn = ctypes.CDLL(str(out_dir / f"{n}.so")).flash_attention_tc_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 6 + [ll] * 9 + [ctypes.c_float, i, i, p]
        fn.restype = i
        launchers[n] = fn

    def run(n, q, k, v, causal=True, window=None):
        b, h, sq, d = q.shape
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
        strides = [st for name, t in (("q", q), ("k", k), ("v", v))
                   for st in fa._tma_strides(name, t)]
        code = launchers[n](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
                            k.shape[1], sq, k.shape[2], d, *strides, d ** -0.5, int(causal),
                            int(window or 0), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{n}: launch error {code}")
        return out

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

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                enable_gqa=True)

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    failed = False
    for case in CASES:
        b, h, hkv, sq, skv, d, causal, window = case
        q, k, v = randn((b, h, sq, d)), randn((b, hkv, skv, d)), randn((b, hkv, skv, d))
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        row = {}
        for n in launchers:
            got = run(n, q, k, v, causal, window)
            row[n] = {"outside_tol": outside_bf16_tol(got, want),
                      "identical": bool(torch.equal(got, run(n, q, k, v, causal, window)))}
            failed |= row[n]["outside_tol"] > 0 or not row[n]["identical"]
        print(json.dumps({"case": list(case), **row}), flush=True)
    q = randn((4, 2048, 32, 128)).transpose(1, 2)
    k, v = randn((4, 2048, 8, 128)).transpose(1, 2), randn((4, 2048, 8, 128)).transpose(1, 2)
    want = ref.flash_attention_chunked(q, k, v, causal=True)
    held = {n: outside_bf16_tol(run(n, q, k, v), want) for n in launchers}
    failed |= any(held.values())
    times = {n: [] for n in launchers}
    for n in list(launchers) + list(launchers)[::-1]:
        times[n].append(median_ms(lambda: run(n, q, k, v)))
    times["sdpa"] = [median_ms(lambda: sdpa(q, k, v))]
    print(json.dumps({"qwen3_prefill_outside_tol": held, "qwen3_prefill_ms": times}), flush=True)
    del q, k, v, want
    q = randn((1, 32, 32768, 128))
    k, v = randn((1, 8, 32768, 128)), randn((1, 8, 32768, 128))
    long = {n: median_ms(lambda: run(n, q, k, v), 3, 2) for n in launchers}
    long["sdpa"] = median_ms(lambda: sdpa(q, k, v), 3, 2)
    print(json.dumps({"prefill_32k_ms": long}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
