"""K executor processes on one host, joined by one ``torch.distributed``
group: the port's counterpart of the reference's K-device mesh, on which
``ddc_shard`` runs one shard a rank and only ClusterSets cross between
ranks.

The ranks are ``torch.multiprocessing`` processes started with ``spawn``
(never ``fork``: the parent may hold a CUDA context), joined by a gloo
group through a ``file://`` store in a temporary directory.  Rank r
works on ``cuda:(r % device_count)``, or on the CPU when asked: on one
card all ranks share it (their contexts time-slice), and gloo, which
moves host memory, is the group's backend (NCCL refuses two ranks on one
card).  ``spawn`` hands each rank the parent's ``sys.path``, so a
parent that imports this package from ``src`` needs nothing more.  The
parent builds the CUDA kernels before it spawns, so the ranks only load
them.  A rank that raises fails the call with its
traceback (the other ranks are stopped); results come back as NumPy
arrays and Python values.

``run_ranks`` runs one function on K ranks; ``run_cases`` runs several
in one spawn, each ``Case`` on the first k ranks of the world in a group
of their own while the others idle, so the spawn is paid once.
``run_ddc_ranks`` / ``run_ddc_cases`` are the entry of the distributed
pipeline, the counterpart of the reference's ``make_ddc_fn``.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import ddc
from repro_torch.kernels import _build, ops

@dataclasses.dataclass
class Case:
    """One job of a spawn: ``fn(rank, group, device, *args)`` on ranks
    0..k−1 of a group of their own."""

    fn: Callable
    k: int
    args: tuple = ()


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank r's device: ``cuda:(r % device_count)``, or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _entry(rank: int, world: int, tmp: str, device: str, timeout_s: float) -> None:
    t_entry = time.time()
    with open(Path(tmp) / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    # One CPU thread a rank: K ranks share the host's cores.
    torch.set_num_threads(1)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    t_ready = time.time()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    groups = {k: None if k == world else dist.new_group(list(range(k)))
              for k in sorted({case.k for case in cases})}
    t_group = time.time()
    results = [case.fn(rank, groups[case.k], dev, *case.args) if rank < case.k else None
               for case in cases]
    dist.destroy_process_group()
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump({"results": results, "t_entry": t_entry, "t_ready": t_ready,
                     "t_group": t_group}, f)


def run_cases(cases: list, world: int | None = None, *, device="cuda", timeout: float = 900.0,
              timing: dict | None = None) -> list:
    """Run every ``Case`` in one spawn of ``world`` ranks (default: the
    largest k), each rank on one CPU thread.  Returns, for each case, the
    list of its ranks' results.  ``timing`` is filled with
    the spawn's start-up seconds: until the slowest rank ran
    (``spawn_s``), its device set up (``device_init_s``) and the group
    formed (``group_init_s``)."""
    world = world or max(case.k for case in cases)
    if any(not 1 <= case.k <= world for case in cases):
        raise ValueError(f"every case needs 1..{world} ranks: {[case.k for case in cases]}")
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_cases: device 'cuda' requested but CUDA is not "
                               "available; pass device='cpu' to run on the CPU")
        _build.build_all()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        # The cases go through a file: a spawn argument larger than a
        # pipe's buffer would hold the parent until each child has
        # imported its modules, one child after another.
        with open(Path(tmp) / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        t0 = time.time()
        ctx = torch.multiprocessing.start_processes(
            _entry, args=(world, tmp, str(device), timeout),
            nprocs=world, join=False, start_method="spawn")
        while not ctx.join(timeout=0.5):
            if time.time() - t0 > timeout:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"run_cases: the ranks did not finish in {timeout} s")
        out = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
    if timing is not None:
        timing.update(spawn_s=max(o["t_entry"] for o in out) - t0,
                      device_init_s=max(o["t_ready"] - o["t_entry"] for o in out),
                      group_init_s=max(o["t_group"] for o in out) - max(o["t_ready"] for o in out))
    return [[out[r]["results"][i] for r in range(case.k)] for i, case in enumerate(cases)]


def run_ranks(fn: Callable, k: int, *args, device="cuda", **kw) -> list:
    """``fn(rank, group, device, *args)`` on K ranks; their results."""
    return run_cases([Case(fn, k, args)], k, device=device, **kw)[0]


# ---------------------------------------------------------------------------
# The distributed DDC pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RanksResult:
    """What ``run_ddc_ranks`` returns: the reference's outputs of
    ``make_ddc_fn``, and each rank's record."""

    glabels: np.ndarray    # (N,) i32, the ranks' global labels in rank order
    gcs: Any               # rank 0's global ClusterSet (NumPy leaves)
    maps: np.ndarray       # (K·C,) i32, the ranks' slot maps in rank order
    meter: dict            # rank 0's CommMeter snapshot
    ranks: list            # per rank: its ClusterSet, meter, launches, sent_bytes, times

    @property
    def sent_bytes(self) -> int:
        return sum(r["sent_bytes"] for r in self.ranks)

    @property
    def phase1_s(self) -> float:
        """From the first rank's start to the last rank's end of phase 1."""
        return max(r["t1"] for r in self.ranks) - min(r["t0"] for r in self.ranks)

    @property
    def phase2_s(self) -> float:
        """From the last rank's end of phase 1 to the last rank's end."""
        return max(r["t2"] for r in self.ranks) - max(r["t1"] for r in self.ranks)


def _device_ms(fn) -> float | None:
    """Device time of one call of ``fn`` under torch.profiler: the sum of
    its kernels' self times (None when the profiler saw no device)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [getattr(e, "self_device_time_total", None) or 0.0 for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / 1e3 if us else None


def ddc_rank(rank: int, group, dev: torch.device, points: np.ndarray, mask: np.ndarray, cfg,
             seed: int = 0, init=None, warmup: int = 0, profile: bool = False) -> dict:
    """One rank of the distributed pipeline: ``ddc_shard`` on this rank's
    equal slice of (N, 2) ``points``, after ``warmup`` unrecorded runs,
    launch counts zeroed just before the recorded run and read just
    after, the ranks started together by a barrier; with ``profile``, one
    more run under torch.profiler gives the rank's device time."""
    k = dist.get_world_size(group)
    per = len(points) // k
    p = torch.as_tensor(points[rank * per:(rank + 1) * per], device=dev)
    m = torch.as_tensor(mask[rank * per:(rank + 1) * per], device=dev)
    lane_init = None if init is None else init[rank]

    def run(meter=None, trace=None):
        return ddc.ddc_shard(p, m, cfg, group, seed=seed, init=lane_init, meter=meter,
                             trace=trace)

    for _ in range(warmup):
        run()
    meter, trace = ddc.CommMeter(), {}
    dist.barrier(group)
    ops.reset_launch_counts()
    t0 = time.time()
    glabels, gcs, my_map = run(meter, trace)
    t2 = time.time()
    launches = ops.launch_counts()
    rec = {"glabels": ddc.host_copy(glabels), "my_map": ddc.host_copy(my_map),
           "gcs": [ddc.host_copy(t) for t in gcs], "meter": meter.snapshot(),
           "launches": {key: v for key, v in launches.items() if v},
           "sent_bytes": trace["sent_bytes"], "merge_calls": trace["merge_calls"],
           "path": trace["path"], "phase1_s": trace["phase1_s"],
           "phase2_s": trace["phase2_s"], "t0": t0, "t1": t0 + trace["phase1_s"], "t2": t2}
    if profile and dev.type == "cuda":
        dist.barrier(group)
        rec["device_ms"] = _device_ms(run)
    return rec


def ddc_result(recs: list) -> RanksResult:
    """The ``RanksResult`` of one ``ddc_case``'s rank records; raises if
    a rank's global ClusterSet or meter differs from rank 0's."""
    first = recs[0]
    for r, rec in enumerate(recs):
        if any(not np.array_equal(a, b) or a.dtype != b.dtype
               for a, b in zip(rec["gcs"], first["gcs"])):
            raise RuntimeError(f"rank {r}'s global ClusterSet differs from rank 0's")
        if rec["meter"] != first["meter"]:
            raise RuntimeError(f"rank {r}'s meter {rec['meter']} differs from rank 0's "
                               f"{first['meter']}")
    return RanksResult(glabels=np.concatenate([rec["glabels"] for rec in recs]),
                       gcs=ddc.ClusterSet(*first["gcs"]),
                       maps=np.concatenate([rec["my_map"] for rec in recs]),
                       meter=first["meter"], ranks=recs)


def ddc_case(points, mask, cfg, k: int, seed=0, init=None, warmup=0, profile=False) -> Case:
    """The ``Case`` of one distributed pipeline (``run_ddc_ranks``'
    arguments); its inputs are checked here, before any rank starts."""
    ddc._check_cfg(cfg)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if cfg.schedule == "async" and k & (k - 1):
        raise ValueError(f"the async schedule needs a power-of-two lane count, got {k}")
    points = np.asarray(points, np.float32)
    mask = np.asarray(mask, bool)
    if len(points) % k or mask.shape != (len(points),):
        raise ValueError(f"{len(points)} points do not split into {k} equal shards")
    return Case(ddc_rank, k, (points, mask, cfg, seed, None if init is None
                              else np.asarray(init, np.float32), warmup, profile))


def run_ddc_cases(jobs: list, world: int | None = None, *, device="cuda",
                  **kw) -> list:
    """Several distributed pipelines in one spawn: each job a dict of
    ``run_ddc_ranks``' arguments (``points``, ``mask``, ``cfg``, ``k``, and
    optionally ``seed``, ``init``, ``warmup``, ``profile``).  Returns a
    ``RanksResult`` per job."""
    cases = [ddc_case(**job) for job in jobs]
    return [ddc_result(recs) for recs in run_cases(cases, world, device=device, **kw)]


def run_ddc_ranks(points, mask, cfg, k: int, *, device="cuda", seed: int = 0, init=None,
                  **kw) -> RanksResult:
    """DDC on K rank processes: (N, 2) ``points`` and the (N,) ``mask`` in
    K equal shards (rank r takes rows r·N/K …, as the reference's
    ``P(axis)`` splits), ``ddc_shard`` on each rank with ``cfg.schedule``.
    Every rank's global ClusterSet and meter must equal rank 0's (it
    raises otherwise), and the result carries rank 0's meter snapshot;
    ``init`` ((K, k, 2)) gives each K-Means rank its initial centres."""
    return run_ddc_cases([dict(points=points, mask=mask, cfg=cfg, k=k, seed=seed, init=init)],
                         k, device=device, **kw)[0]
