#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s LM training phase alone on one card: the
``TRAIN_ARCHS`` models (or those named), the checkpoint-resume check, and
with no names or with ``cli`` the ``launch/train.py`` and example runs.

    python3 tools/train_phase.py [ARCH ...] [cli]

Prints the phase's lines (``lm_train``, ``lm_train_checkpoint``,
``lm_train_cli``) as ``chip_smoke.py`` does, after the card's name and
power limit and the kernels' build time, and exits non-zero on a failed
gate.  Needs a CUDA card and nvcc; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        print("train_phase: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    names = sys.argv[1:] if argv is None else argv
    cs.TRAIN_ARCHS = {k: v for k, v in cs.TRAIN_ARCHS.items() if not names or k in names}
    t0 = time.perf_counter()
    _, per_step = cs.lm_train_phase(torch, torch.device("cuda"), card)
    print(json.dumps({"train_launches_per_step": per_step}), flush=True)
    if not names or "cli" in names:
        print(json.dumps({"lm_train_cli": cs.train_cli_runs(torch, ops)}), flush=True)
    print(json.dumps({"lm_train_phase_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
