"""Discrete-event simulator of DDC on a heterogeneous cluster (a copy of
the reference package's ``core/simulate.py``).

The paper's experiments run on eight heterogeneous desktops (Table 1).
To reproduce the paper's wall-clock
behaviour (Tables 3–6: sync vs async, waiting time, load skew) we model
the cluster explicitly:

* machine i runs phase 1 in  t1_i = c_i * n_i^2  (DBSCAN, O(n^2)) plus a
  contour term  d_i * c log c  — coefficients calibrated from the paper's
  own Table 3 (measured step-1 times vs shard sizes);
* phase 2 is a binary merge tree over machines.  ``sync``: nobody merges
  before the global barrier at max_i(t1_i) (the paper's synchronous
  model; step 2 *includes waiting*, which is how the paper reports it).
  ``async``: each merge fires as soon as both inputs are ready
  (event-driven), so fast machines finish long before stragglers.

The same event engine also drives the straggler-mitigation analysis
(capacity-aware sharding, DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence



@dataclasses.dataclass(frozen=True)
class MachineSpec:
    name: str
    step1_coeff: float        # ms per point^2 (DBSCAN)
    contour_coeff: float = 2e-4   # ms per point*log(point) (reduction)
    merge_ms: float = 150.0   # ms per pairwise contour merge
    link_ms: float = 40.0     # ms per contour transfer (latency + tiny payload)
    async_poll_ms: float = 20.0  # readiness bookkeeping per async merge
    # (paper §5.4: "in the asynchronous model the machines still need to
    # execute the algorithm that checks which one finished first", which
    # is why sync wins slightly when loads are balanced — Table 6)


# Coefficients calibrated from paper Table 3 (step1 time / size^2):
PAPER_MACHINES = [
    MachineSpec("M1-XPS", 21270 / 10000**2),
    MachineSpec("M2-Insp3721", 1060 / 2500**2),
    MachineSpec("M3-Insp3521", 5093 / 3275**2),
    MachineSpec("M4-iMac2010", 4592 / 5000**2),
    MachineSpec("M5-Insp5559", 227 / 1666**2),
    MachineSpec("M6-iMac2009", 292 / 2000**2),
    MachineSpec("M7-MacAir", 7520 / 5000**2),
    MachineSpec("M8-extra", 200 / 1500**2),
]


@dataclasses.dataclass
class SimResult:
    step1: list[float]        # per-machine phase-1 compute time (ms)
    step2: list[float]        # per-machine phase-2 time incl. waiting (ms)
    total: list[float]        # per-machine completion time (ms)
    makespan: float           # overall completion (ms)
    idle: list[float]         # per-machine waiting time inside step 2


def phase1_time(m: MachineSpec, n_points: int) -> float:
    t = m.step1_coeff * n_points * n_points
    c = max(int(0.02 * n_points), 2)  # contour input: the cluster points
    return t + m.contour_coeff * c * math.log2(c)


def simulate(
    machines: Sequence[MachineSpec],
    sizes: Sequence[int],
    schedule: str = "async",
) -> SimResult:
    """Simulate one DDC run.  Binary merge tree over machine index
    (leader = lower index of each pair, as in the paper's leader election).
    """
    k = len(machines)
    assert k == len(sizes) and k & (k - 1) == 0, (k, len(sizes))
    t1 = [phase1_time(m, n) for m, n in zip(machines, sizes)]

    done = list(t1)  # completion time per machine (leaf done when sent)

    def merge_cost(m: MachineSpec, combined_shards: int) -> float:
        # Merging accumulates contours: deeper merges handle more clusters
        # (paper: phase-2 complexity grows with total contour vertices).
        import math
        return m.merge_ms * (1 + 0.75 * max(math.log2(combined_shards) - 1, 0))

    if schedule == "sync":
        # Barrier at max(t1), then a fixed binary merge tree (the paper's
        # synchronous model: nobody merges before everyone finished).
        barrier = max(t1)
        ready = [barrier] * k
        level = 1
        while level < k:
            for base in range(0, k, 2 * level):
                leader, peer = base, base + level
                arrive = ready[peer] + machines[peer].link_ms
                start = max(ready[leader], arrive)
                ready[leader] = start + merge_cost(machines[leader], 2 * level)
            level *= 2
        makespan = ready[0]
        # Paper convention: in the sync model every machine blocks until
        # the global merge finishes (Tables 3–5 report near-equal totals).
        done = [makespan] * k
    else:
        # Event-driven: repeatedly merge the two earliest-ready contours
        # ("machines which finished early can advance to the next step").
        # The later-arriving side pays the link; the waiting side leads the
        # merge and pays merge + poll bookkeeping (paper §5.4).
        frontier = [(t1[i], i, 1) for i in range(k)]
        while len(frontier) > 1:
            frontier.sort()
            (r1, i1, s1), (r2, i2, s2) = frontier[0], frontier[1]
            leader, peer = i1, i2              # earliest-ready leads
            arrive = r2 + machines[peer].link_ms
            start = max(r1, arrive)
            finish = (start + merge_cost(machines[leader], s1 + s2)
                      + machines[leader].async_poll_ms)
            done[peer] = max(done[peer], arrive)
            done[leader] = finish
            frontier = frontier[2:] + [(finish, leader, s1 + s2)]
        makespan = frontier[0][0]

    step2 = [d - t for d, t in zip(done, t1)]
    busy2 = [machines[i].merge_ms * _merges_led(i, k) for i in range(k)]
    idle = [max(s - b, 0.0) for s, b in zip(step2, busy2)]
    return SimResult(
        step1=t1, step2=step2, total=list(done), makespan=makespan, idle=idle
    )


def _merges_led(i: int, k: int) -> int:
    led = 0
    level = 1
    while level < k:
        if i % (2 * level) == 0:
            led += 1
        level *= 2
    return led


def sequential_time(machine: MachineSpec, n_points: int) -> float:
    """T1 for the speedup experiment: full dataset on one machine, no
    reduction / aggregation (paper §5.5)."""
    return machine.step1_coeff * n_points * n_points
