"""Scale-out dry run: the 1 T-parameter configuration on 2,048 ranks (the
port's counterpart of the reference package's ``launch/dryrun_scaleout.py``).

kimi-k2's train_4k step on an (8, 16, 16) mesh of (pod, data, model) with
FSDP, remat "full", the MoE's a2a island and its int8 wire: per-rank
memory falls about as 1 / ranks to a size that fits a card.  One process
plays rank 0 of 2,048 (``launch/dryrun.py``); nothing touches a card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_scaleout [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import dryrun as dr

ARCH = "kimi-k2-1t-a32b"
MESH = ((8, 16, 16), ("pod", "data", "model"))


def run(device="cuda") -> dict:
    """The scale-out record: memory a rank, whether it fits an H100 80GB,
    and the three terms."""
    # 2 microbatches: the per-micro batch (128) must divide the 128 DP
    # lanes (8 pods x 16) — 8 microbatches would leave 32-per-micro,
    # silently replicated by the divisibility fallback.
    rec = dr.run_cell(ARCH, "train_4k", False,
                      pctx_overrides=dict(moe_impl="a2a", a2a_int8=True),
                      tcfg=dr.train_recipe(ARCH, microbatches=2), device=device, mesh=MESH)
    if rec["status"] != "ok":
        raise RuntimeError(f"the scale-out cell failed: {rec.get('error')}\n{rec.get('trace')}")
    return {"arch": ARCH, "shape": "train_4k", "mesh": "8x16x16 (2048 ranks)",
            **{k: rec[k] for k in ("hbm_per_device_gb", "fits_h100_80gb", "memory",
                                   "t_compute", "t_memory", "t_collective", "bottleneck",
                                   "coll_counts", "coll_detail", "kernels", "traced",
                                   "trace_s")}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="whose routes the count takes (launch/dryrun.py)")
    ap.add_argument("--out", default="results/dryrun_scaleout.json")
    args = ap.parse_args(argv)
    rec = run(args.device)
    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([rec], f, indent=1)
    return rec


if __name__ == "__main__":
    main()
