"""Rank functions for tests/test_torch_ranks.py.  The ranks import this
module by name, so it imports neither JAX nor the test module."""
import dataclasses

import numpy as np
import torch

from repro_torch.core import ddc

# name -> the DDCConfig fields that ddc_shard must refuse on a 6-rank group.
BAD_CONFIGS = {"async-k6": dict(schedule="async"),
               "tree-degree-1": dict(schedule="tree", tree_degree=1),
               "unknown-schedule": dict(schedule="ring")}


def bad_configs(rank, group, dev):
    """ddc_shard with each of ``BAD_CONFIGS`` on this rank: the error's
    type and message for each (None if it ran)."""
    pts = torch.as_tensor(np.random.default_rng(rank).uniform(0, 1, (64, 2)), device=dev)
    mask = torch.ones(64, dtype=torch.bool, device=dev)
    out = {}
    for name, fields in BAD_CONFIGS.items():
        cfg = dataclasses.replace(ddc.DDCConfig(eps=0.1, grid=16, max_clusters=4,
                                                max_verts=8), **fields)
        try:
            ddc.ddc_shard(pts, mask, cfg, group)
            out[name] = None
        except ValueError as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def raise_on_rank_one(rank, group, dev):
    """Rank 1 raises; rank 0 waits for it in a barrier."""
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    torch.distributed.barrier(group)
