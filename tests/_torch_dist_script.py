"""The port's dist engine against the reference package's dist engine, run
under a forced host device count by tests/test_torch_dist_oracle.py (the
reference pins one shard per JAX device, and the count must be set before
JAX starts, which the pytest process has already done with one device).

Both engines take the same calls: the port's
``DistClusterService(device="cpu")`` and ``repro.serve.DistClusterService``.
After every refresh they are compared bit for bit with
tests/test_torch_stream.py's ``check`` (global and dense labels, slot maps,
the stacked ClusterSets, pair-d2, host mirrors, counters, the meter's
snapshot, the published snapshot).

Modes (argv[1]):

* a ``PHASE2_LAYOUTS`` name (or ``all``) — for K in {2, 4, 8}: stream the
  layout in, a forced full re-merge, the meter's exact bytes (|dirty|·B +
  K·C·4 a delta refresh, K·B + K·C·4 a full re-merge), routed queries,
  ``state_dict`` arrays and manifest, each package restoring the other's
  state, and a drop healed by a retry and a poisoned delta quarantined and
  recovered, the retry's refetch metered in both.  8 devices.
* ``hier`` — the tree of aggregators on dist: 16 shards at degree 4 and
  8 shards at degree 2.  16 devices.
* ``orderings`` — shuffled ingest with interleaved evictions and a TTL
  expiry (hypothesis draws, or fixed examples without it).  8 devices.

Prints one PASS line a case, then ALL_OK; any failure raises.
"""
import os
import sys

MODE = sys.argv[1] if len(sys.argv) > 1 else "all"
os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                           f"{16 if MODE == 'hier' else 8}")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _hyp import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402
from repro.core import ddc as jddc  # noqa: E402
from repro.serve import cluster_service as jcs  # noqa: E402
from repro.serve import dist_service as jds  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402
from repro_torch.serve import cluster_service as tcs  # noqa: E402
from repro_torch.serve import dist_service as tds  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from test_torch_dist import View  # noqa: E402
from test_torch_stream import check, eq, layout_kw  # noqa: E402

N = 2048
SHARD_COUNTS = (2, 4, 8)
HIER_CELLS = ((16, 4), (8, 2))


class Pair:
    """The port's dist engine (``t``) and the reference's (``j``) driven
    by the same calls; ``refresh`` compares them."""

    def __init__(self, layout, k, capacity=None, max_batch=256, faults=(None, None), **skw):
        cap = capacity or tsp.shard_capacity(N, k)
        kw = dict(shards=k, capacity=cap, max_batch=min(max_batch, cap), **skw)
        jcfg = jddc.DDCConfig(**layout_kw(layout))
        self.j = jds.DistClusterService(jcs.StreamConfig(ddc=jcfg, **kw),
                                        meter=jddc.CommMeter(), faults=faults[1])
        self.t = tds.DistClusterService(
            tcs.StreamConfig(ddc=tddc.DDCConfig(**layout_kw(layout)), **kw),
            meter=tddc.CommMeter(), faults=faults[0], device="cpu")

    def both(self, name, *args, **kw):
        return getattr(self.t, name)(*args, **kw), getattr(self.j, name)(*args, **kw)

    def refresh(self, **kw):
        self.both("refresh", **kw)
        self.check()

    def check(self):
        check(View(self.t), self.j)
        if self.j.hierarchy is not None:
            assert self.t.hierarchy.last_stats == self.j.hierarchy.last_stats

    def query(self, q):
        got, want = self.both("query", q)
        eq(got.labels, want.labels, "query labels")
        assert (got.version, got.degraded, got.scanned_shards) == \
            (want.version, want.degraded, want.scanned_shards)
        return got


def plans(*events, **kw):
    return (tfaults.FaultPlan(events=tuple(tfaults.FaultEvent(*e) for e in events), **kw),
            jfaults.FaultPlan(events=tuple(jfaults.FaultEvent(*e) for e in events), **kw))


def stream_in(pair, pts, k, batch=256, order="round_robin", seed=None):
    for shard, chunk in tsp.stream_batches(pts, k, batch, order=order, seed=seed):
        pair.both("ingest", shard, chunk)
        pair.refresh()


def meter_reset(pair):
    for svc in (pair.t, pair.j):
        svc.meter.reset()


def check_layout(layout: str):
    pts = tsp.PHASE2_LAYOUTS[layout]["make"](N)
    for k in SHARD_COUNTS:
        pr = Pair(layout, k)
        stream_in(pr, pts, k)
        d2 = pr.t.pair_d2
        pr.both("remerge_full")
        pr.check()
        eq(pr.t.pair_d2, d2, "delta == full re-merge")
        b, c = pr.t.cfg.buffer_bytes(), pr.t.cfg.max_clusters
        meter_reset(pr)
        pr.both("ingest", 0, pts[:8])
        pr.refresh()
        assert pr.t.meter.snapshot()["bytes_total"] == b + k * c * 4
        meter_reset(pr)
        pr.both("remerge_full")
        pr.check()
        assert pr.t.meter.snapshot()["bytes_total"] == k * b + k * c * 4
        rng = np.random.default_rng(k)
        pr.query(np.concatenate([pts[rng.integers(0, N, 200)],
                                 rng.uniform(0, 1, (100, 2)).astype(np.float32),
                                 np.array([[5.0, 5.0]], np.float32)]))
        # state_dict: equal arrays and manifest; each package restores the
        # other's state and the restored pair carries on equal.
        pr.both("ingest", k - 1, pts[8:40])
        (ta, tm), (ja, jm) = pr.t.state_dict(), pr.j.state_dict()
        assert sorted(ta) == sorted(ja) and tm == jm
        for key in ja:
            eq(ta[key], ja[key], key)
        back = Pair.__new__(Pair)
        back.t = tds.DistClusterService.from_state(
            pr.t.scfg, {key: np.array(v, copy=True) for key, v in ja.items()}, jm,
            meter=tddc.CommMeter(), device="cpu")
        back.j = jds.DistClusterService.from_state(
            pr.j.scfg, {key: np.array(v, copy=True) for key, v in ta.items()}, tm,
            meter=jddc.CommMeter())
        back.check()
        for p in (pr, back):
            p.refresh()
            p.both("ingest", 1, pts[40:72])
            p.refresh()
        eq(back.t.stacked("_glabels"), pr.t.stacked("_glabels"))
        # Faults: a drop healed by one retry (the refetch metered), then a
        # poisoned delta quarantined, routed around, and recovered.
        pr.t.faults, pr.j.faults = plans(("drop", 1, None, 1))
        pr.both("ingest", 1, pts[72:104])
        pr.refresh()
        assert pr.t.retries == 1 and not pr.t.quarantined
        pr.t.faults, pr.j.faults = plans(("poison", 0), seed=3)
        pr.both("ingest", 0, pts[104:136])
        pr.refresh()
        assert 0 in pr.t.quarantined
        pr.query(pts[::17])
        pr.t.faults = pr.j.faults = None
        assert pr.both("recover_all") == ([0], [0])
        pr.refresh()
        assert not pr.t.quarantined
        print(f"PASS {layout} k={k}", flush=True)


def check_hier():
    pts = tsp.PHASE2_LAYOUTS["linked_ovals"]["make"](N)
    for k, degree in HIER_CELLS:
        pr = Pair("linked_ovals", k, max_batch=128, agg_degree=degree)
        stream_in(pr, pts, k, batch=128)
        pr.both("ingest", k - 1, pts[:64])
        pr.refresh()
        pr.both("remerge_full")
        pr.check()
        pr.query(pts[::9])
        print(f"PASS hier k={k} degree={degree}", flush=True)


def one_ordering(seed: int, k: int, batch: int, evict_step: int):
    """Shuffled ingest (and interleaved evictions): the two dist engines
    equal after every refresh, under any ordering."""
    pts = tsp.PHASE2_LAYOUTS["linked_ovals"]["make"](N)
    pr = Pair("linked_ovals", k, max_batch=batch)
    batches = tsp.stream_batches(pts, k, batch, order="shuffled", seed=seed)
    victims = np.random.default_rng(seed).integers(0, k, size=len(batches))
    for i, (shard, chunk) in enumerate(batches):
        pr.both("ingest", shard, chunk, t=float(i))
        if evict_step and i % evict_step == evict_step - 1:
            pr.both("evict_oldest", int(victims[i]), int(batch // 4))
        pr.refresh()
    if evict_step:
        for s in range(k):
            pr.both("evict_older_than", s, 1.0)
        pr.refresh()


def check_orderings():
    if HAVE_HYPOTHESIS:
        @settings(max_examples=4, deadline=None)
        @given(seed=st.integers(0, 2**31 - 1), k=st.sampled_from((2, 4)),
               batch=st.sampled_from((128, 256)), evict_step=st.sampled_from((0, 3, 4, 5, 6)))
        def run(seed, k, batch, evict_step):
            one_ordering(seed, k, batch, evict_step)

        run()
    else:
        for args in ((0, 2, 256, 3), (3, 2, 256, 0), (7, 4, 128, 5)):
            one_ordering(*args)
    print("PASS orderings", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    if MODE == "orderings":
        check_orderings()
    elif MODE == "hier":
        check_hier()
    else:
        for name in (list(tsp.PHASE2_LAYOUTS) if MODE == "all" else [MODE]):
            check_layout(name)
    print("ALL_OK")
