"""Hierarchical tree-of-aggregators (DESIGN.md §13).

Counterpart of the reference package's ``serve/hierarchy.py``, its node
batches, caches and summaries on a torch device (a CUDA card by default,
the CPU when the caller asks for it).

The flat serve engine funnels every delta into ONE aggregator that owns
the global ClusterSet and the full (K·C)² pair-d2 cache — the scaling
ceiling past a few dozen shards (the paper's aggregation phase promises
the opposite: "does not involve the exchange of large amounts of data").
``AggregatorTree`` replaces it with a D-ary tree of small aggregators
layered over the SAME core primitives:

- every node owns a stacked (D, C, …) ClusterSet of its children's
  summaries, a (D·C)² pair-d2 cache over only those slots, and the
  folded C-slot summary it exports upward;
- a node refresh IS ``core.ddc.merge_delta`` with node-local dirty child
  positions and a node-local exclude mask — patch the dirty rows of the
  node cache (B5's rectangular form: the dirty children's C rows each
  against the node's D·C slots), refold (``merge_from_d2``); a full
  rebuild runs B5's square form;
- a dirty shard patches its leaf node and propagates up the ancestor
  path only; propagation stops the moment a node's exported summary is
  bit-identical to what the parent already holds (absorption);
- the root publishes the global set, and per-shard slot maps are
  composed down the path (``x → parent_map[x]`` per level, the
  ``merge_tree`` idiom), then canonically relabeled so per-shard
  ``glabels`` stay bit-identical to the flat aggregator.

Exactness argument (why labels match the flat path bit-for-bit):

1. Per node, the delta-patched cache equals a from-scratch
   ``contour_pair_d2_exact`` of its batch (DESIGN §8 — one expression per
   slot pair, IEEE-symmetric mirror), so each fold is independent of
   patch history; ``cache_exact()`` asserts this.
2. The flat fold labels a component by rank (member-count, descending)
   with ties broken by the component's minimum flat slot index (the
   min-label closure + stable argsort in ``merge_from_d2``).  Component
   member sets survive re-aggregation (the ``merge_tree ≡ merge_sync``
   equivalence), member counts are exact integer sums in any association
   order, and the minimum flat slot of a component is order-free — so
   re-ranking the ROOT's slots by (size desc, min composed flat slot asc)
   reproduces the flat aggregator's slot ids exactly.  That canonical
   relabel is the last step of every refresh.  It holds where no node
   contour fills ``max_verts``: internal nodes re-extract merged contours
   level by level, and a contour cut to the budget can merge differently
   in a subtree than all at once (DESIGN.md §7).

The map algebra of the down pass (``_compose_down``) runs on the host in
NumPy, as the reference's does: its ``np.lexsort`` and ``np.minimum.at``
decide the flat slot ids.

Failure model (§11) composition: the engine's quarantine mask is applied
at the LEAF fold only — an excluded shard's slots are treated invalid at
its leaf node, the leaf's summary no longer carries them, and every
ancestor refold is automatically quarantine-free.  The shard's cached
rows in its leaf stay intact, so rejoin is one ordinary row patch, same
as the flat engine.

Aliasing: a node's batch is written in place (row copies from the
engine's mirror or from a child's summary); summaries, maps and the
global set are new tensors on every fold and are never written into, so
a ClusterSet held by a parent's comparison, the engine or a snapshot
stays as it was.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ddc as core_ddc

ClusterSet = core_ddc.ClusterSet

_BIG = np.iinfo(np.int32).max


def _cs_equal(a: ClusterSet, b: ClusterSet) -> bool:
    """Bitwise equality of two ClusterSets, compared on their device."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


@dataclasses.dataclass
class _Node:
    """One aggregator in the tree.

    ``children`` are shard ids at level 0 (the leaf-node level) and
    previous-level node positions above it; the stacked ``batch`` is
    padded with empty ClusterSets when a node has fewer than D children,
    so every fold in the tree has one shape.
    """

    children: List[int]
    batch: ClusterSet
    pair_d2: Optional[torch.Tensor] = None
    summary: Optional[ClusterSet] = None
    maps: Optional[torch.Tensor] = None       # (D, C) child slot → summary slot
    to_root: Optional[np.ndarray] = None      # (C,) summary slot → root slot


class AggregatorTree:
    """A D-ary tree of delta-cached aggregators over K shards.

    Host-driven like the flat control plane: ``refresh(batch, dirty,
    exclude)`` takes the engine's (K, C, …) aggregator mirror, the list of
    freshly staged shard ids (None = full rebuild of every node cache
    from scratch), and the quarantine mask, and returns the
    ``(global ClusterSet, (K, C) slot maps)`` pair in exactly the flat
    aggregator's contract — callers cannot tell the topologies apart
    except through the comm meter.  ``device`` holds the node state (the
    engine passes its own).
    """

    def __init__(self, shards: int, degree: int, cfg: core_ddc.DDCConfig,
                 meter: Optional[core_ddc.CommMeter] = None, *, device="cuda"):
        if degree < 2:
            raise ValueError(f"agg_degree must be >= 2, got {degree}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "AggregatorTree: device 'cuda' requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        self.shards = int(shards)
        self.degree = int(degree)
        self.cfg = cfg
        self.meter = meter
        self.levels: List[List[_Node]] = []
        members = list(range(self.shards))
        while True:
            level = [
                _Node(children=members[i:i + self.degree], batch=self._empty_batch())
                for i in range(0, len(members), self.degree)
            ]
            self.levels.append(level)
            if len(level) == 1:
                break
            members = list(range(len(level)))
        self._last_exclude: Optional[np.ndarray] = None
        self._global: Optional[ClusterSet] = None
        self._maps: Optional[torch.Tensor] = None
        self._prev_m: Optional[np.ndarray] = None
        self.last_stats: dict = {}

    # -- topology ----------------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def n_nodes(self) -> int:
        return sum(len(level) for level in self.levels)

    @property
    def internal_edges(self) -> int:
        """Node→node edges (excludes the K shard→leaf edges)."""
        return self.n_nodes - 1

    @property
    def ready(self) -> bool:
        return self.levels[-1][0].summary is not None

    def _empty_batch(self) -> ClusterSet:
        """D all-invalid ClusterSets, stacked, on the tree's device (a
        new batch per node: each node's batch is written in place)."""
        empty = core_ddc.empty_clusterset(self.cfg, device=self.device)
        return ClusterSet(*(t[None].expand((self.degree,) + t.shape).clone()
                            for t in empty))

    # -- introspection (tests, chaos sweep) --------------------------------

    def cache_arrays(self) -> List[np.ndarray]:
        """Every built node cache, level order — the hierarchical
        counterpart of the flat engine's ``pair_d2`` property (copies)."""
        return [core_ddc.host_copy(node.pair_d2)
                for level in self.levels for node in level
                if node.pair_d2 is not None]

    def cache_exact(self) -> bool:
        """True iff every node's delta-patched cache is bit-identical to
        a from-scratch rebuild over its current batch — the per-node
        DESIGN §8 invariant the whole exactness argument rests on."""
        for level in self.levels:
            for node in level:
                if node.pair_d2 is None:
                    continue
                scratch = core_ddc.contour_pair_d2_exact(node.batch, self.cfg)
                if not torch.equal(node.pair_d2, scratch):
                    return False
        return True

    # -- refresh -----------------------------------------------------------

    def refresh(self, batch: ClusterSet, dirty=None, exclude=None
                ) -> Tuple[ClusterSet, torch.Tensor]:
        """Fold the engine mirror through the tree.

        ``batch``: the (K, C, …) stacked per-shard ClusterSets (leaf
        payloads are copied from it row-by-row, so only dirty shards'
        rows are ever read on the delta path).  ``dirty``: staged shard
        ids, or None to rebuild every node cache from scratch.
        ``exclude``: optional (K,) bool quarantine mask (a tensor or an
        array), honored at the leaf fold (see module docstring).
        """
        cfg, d = self.cfg, self.degree
        c = cfg.max_clusters
        if exclude is None:
            exclude_np = None
        elif isinstance(exclude, torch.Tensor):
            exclude_np = core_ddc.host_copy(exclude).astype(bool)
        else:
            exclude_np = np.asarray(exclude, bool).copy()
        full = dirty is None or not self.ready
        stats = {"folds": 0, "absorbed": 0, "up_shard_payloads": 0,
                 "internal_up_edges": 0, "down_internal_edges": 0,
                 "down_shard_rows": 0, "bottleneck_bytes": 0}
        load: dict = {}
        bbytes = cfg.buffer_bytes()

        # Which leaf nodes must act, and which member slots changed.
        pending: dict = {}
        if full:
            for ni, node in enumerate(self.levels[0]):
                pending[ni] = set(range(len(node.children)))
            stats["up_shard_payloads"] = self.shards
        else:
            for s in dirty:
                pending.setdefault(int(s) // d, set()).add(int(s) % d)
            stats["up_shard_payloads"] = len(set(int(s) for s in dirty))
            # A quarantine flip without a staged delta still forces the
            # affected leaf to refold (no cache patch — rows are intact).
            prev = self._last_exclude
            for ni, node in enumerate(self.levels[0]):
                for s in node.children:
                    was = bool(prev[s]) if prev is not None else False
                    now = bool(exclude_np[s]) if exclude_np is not None else False
                    if was != now:
                        pending.setdefault(ni, set())
        self._last_exclude = exclude_np

        any_changed = False
        for li, level in enumerate(self.levels):
            next_pending: dict = {}
            for ni in sorted(pending):
                node = level[ni]
                positions = sorted(pending[ni])
                for j in positions:
                    if li == 0:
                        row = [x[node.children[j]] for x in batch]
                    else:
                        row = self.levels[li - 1][node.children[j]].summary
                    for dst, src in zip(node.batch, row):
                        dst[j] = src
                if positions and li == 0:
                    load[(li, ni)] = load.get((li, ni), 0) + len(positions) * bbytes
                excl = None
                if li == 0 and exclude_np is not None:
                    bits = np.zeros((d,), bool)
                    for j, s in enumerate(node.children):
                        bits[j] = exclude_np[s]
                    if bits.any():
                        excl = torch.from_numpy(bits).to(self.device)
                use_cache = not full and node.pair_d2 is not None
                prev_summary, prev_maps = node.summary, node.maps
                node.summary, node.maps, node.pair_d2 = core_ddc.merge_delta(
                    node.batch,
                    node.pair_d2 if use_cache else None,
                    positions if use_cache else None,
                    cfg, excl)
                stats["folds"] += 1
                if self.meter is not None:
                    self.meter.add_merge(d, c)
                summary_changed = (prev_summary is None
                                   or not _cs_equal(prev_summary, node.summary))
                maps_changed = (prev_maps is None
                                or not torch.equal(prev_maps, node.maps))
                any_changed = any_changed or summary_changed or maps_changed
                if summary_changed and li + 1 < len(self.levels):
                    next_pending.setdefault(ni // d, set()).add(ni % d)
                    stats["internal_up_edges"] += 1
                    load[(li, ni)] = load.get((li, ni), 0) + bbytes
                    load[(li + 1, ni // d)] = load.get((li + 1, ni // d), 0) + bbytes
                    if self.meter is not None:
                        self.meter.add_collective(1, bbytes)
                elif not summary_changed:
                    stats["absorbed"] += 1
            pending = next_pending
            if not pending and li + 1 < len(self.levels):
                break

        if any_changed or self._maps is None:
            self._compose_down(stats, load)
        stats["bottleneck_bytes"] = max(load.values(), default=0)
        self.last_stats = stats
        return self._global, self._maps

    # -- down pass: map composition + canonical relabel --------------------

    def _compose_down(self, stats: dict, load: dict) -> None:
        cfg, k = self.cfg, self.shards
        c = cfg.max_clusters
        root = self.levels[-1][0]
        root.to_root = np.arange(c, dtype=np.int64)
        for li in range(len(self.levels) - 1, 0, -1):
            for ni, parent in enumerate(self.levels[li]):
                pmaps = core_ddc.host_copy(parent.maps).astype(np.int64)
                for j, child_pos in enumerate(parent.children):
                    child = self.levels[li - 1][child_pos]
                    m = pmaps[j]
                    child.to_root = np.where(
                        m >= 0, parent.to_root[np.clip(m, 0, c - 1)], -1)
                    stats["down_internal_edges"] += 1
                    load[(li, ni)] = load.get((li, ni), 0) + c * 4
                    load[(li - 1, child_pos)] = load.get((li - 1, child_pos), 0) + c * 4
                    if self.meter is not None:
                        self.meter.add_collective(1, c * 4)
        m0 = np.full((k, c), -1, np.int64)
        for ni, node in enumerate(self.levels[0]):
            nmaps = core_ddc.host_copy(node.maps).astype(np.int64)
            for j, s in enumerate(node.children):
                m = nmaps[j]
                m0[s] = np.where(m >= 0, node.to_root[np.clip(m, 0, c - 1)], -1)

        # Canonical relabel: reproduce the flat aggregator's slot ids —
        # rank root components by member count (desc), ties by the
        # minimum composed flat slot index (the flat closure's min-label
        # root, see module docstring).
        sizes = core_ddc.host_copy(root.summary.sizes).astype(np.int64)
        valid = core_ddc.host_copy(root.summary.valid).astype(bool)
        rank = np.where(valid, sizes, -1)
        flat0 = m0.reshape(-1)
        first = np.full((c,), _BIG, np.int64)
        sel = flat0 >= 0
        np.minimum.at(first, flat0[sel], np.nonzero(sel)[0])
        perm = np.lexsort((first, -rank))
        relabel = np.full((c,), -1, np.int64)
        for pos, r in enumerate(perm):
            if rank[r] > 0:
                relabel[r] = pos
        m_final = np.where(m0 >= 0, relabel[np.clip(m0, 0, c - 1)], -1).astype(np.int32)
        if self._prev_m is not None:
            stats["down_shard_rows"] = int((m_final != self._prev_m).any(axis=1).sum())
        else:
            stats["down_shard_rows"] = k
        for ni, node in enumerate(self.levels[0]):
            load[(0, ni)] = load.get((0, ni), 0) + len(node.children) * c * 4
        self._prev_m = m_final

        dev = self.device
        perm_t = torch.from_numpy(perm).to(dev)
        keep_t = torch.from_numpy(rank[perm] > 0).to(dev)
        summary = root.summary
        self._global = ClusterSet(
            contours=summary.contours[perm_t],
            counts=torch.where(keep_t, summary.counts[perm_t], 0),
            sizes=torch.where(keep_t, summary.sizes[perm_t], 0),
            valid=keep_t,
            overflow=summary.overflow.clone(),
        )
        self._maps = torch.from_numpy(m_final).to(dev)
