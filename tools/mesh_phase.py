#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s LM mesh phase alone on one card: qwen3-8b and
llama4-scout at full width over 4 rank processes, one step each of
mamba2-1.3b and minicpm3-4b with their layers computed on their shards
(2 layers, model 4), the serve CLI over 2, NCCL at world size 1, and B9's
int8 mode at the a2a send shape.

    python3 tools/mesh_phase.py [--control] [--dryrun]

``--control`` adds the controls of the update gates: rank 0 also reads
the one-rank update of data lane 0's half of the batch against the whole
batch's (qwen3-8b's AdamW step, llama4-scout's Adafactor step).
``--dryrun`` then runs the ``lm_dryrun`` phase on the phase's readings
and times B7, B8 and B9 at the float32 training shapes (their kernels-line
``at_training_shape`` entries).  Prints the phase's ``lm_mesh`` line and
the int8 kernel entry after the card's name and power limit and the
kernels' build time, and exits non-zero on a failed gate.  Needs a CUDA
card and nvcc; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device is available", file=sys.stderr)
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
    line, entry = cs.lm_mesh_phase(torch, np, ops, ref, torch.device("cuda"), card,
                                control="--control" in sys.argv[1:])
    print(json.dumps({"kernel": entry}), flush=True)
    if "--dryrun" in sys.argv[1:]:
        cs.lm_dryrun_phase(torch, ops, line, card)
        print(json.dumps({"at_training_shape": cs.train_shape_entries(
            torch, ops, ref, torch.device("cuda"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
