"""Device-resident streaming DDC data plane (the ``dist`` backend).

Counterpart of the reference package's ``serve/dist_service.py``.
``ClusterService`` keeps K rings on its device and meters the phase-2
exchange with a model.  This engine keeps the same control plane
(``ShardControlPlane``: slot choice, eviction, TTL stamps, bbox routing,
dirty tracking, the failure model) but gives each shard a lane of its own
(``launch.mesh.make_lane_mesh``) and makes the exchange real:

* **Lane buffers** — each lane owns its (cap, 2) points, (cap,) live mask,
  (cap,) dense local labels and global labels, and its last phase-1
  ClusterSet row.  On a card every lane issues its work on its own CUDA
  stream; on the CPU in order.  One card holds any number of lanes (the
  reference needs one device per shard).
* **Lane-local ingest, eviction and phase 1** — a write uploads only its
  lane's payload, on the lane's stream; a refresh runs ``local_phase`` on
  each dirty lane's stream (B3 / B4, or B1 / B2 where dense); an emptied
  lane takes the cached empty ClusterSet and dense −1; a clean lane keeps
  its row.
* **Delta-ClusterSet exchange** — the only payload that crosses to the
  aggregator: a delta refresh fetches the dirty lanes' rows in one
  gathered copy, a full re-merge all K rows, and the meter counts the
  bytes of what was fetched (``compress.pytree_wire_bytes``), one
  collective; each lane's (C,) slot-map row goes back down, counted from
  the maps pushed, and each lane relabels its points on its stream.  The
  aggregator (the control plane's ClusterSet mirror and cached pair-d2
  matrix, on the device's current stream) patches the dirty rows with
  ``core.ddc.merge_delta``, the stream engine's code path, so labels and
  the cached matrix equal the ``stream`` engine's bit for bit.
* **Routed queries** — each lane whose ε-dilated bbox could hold a
  neighbour computes (best d2, label) per query over its own buffers:
  d2 = fma(dy, dy, dx·dx) as the reference's jitted lane query compiles
  it, the first index on a tie, BIG where a point is not live or not
  clustered.  The host folds the lanes in ascending shard order with a
  strict ``<``, so ties go to the lowest (shard, slot), as the flat
  argmin of the stream engine.

Cross-stream lifetimes follow ``launch.mesh``: a lane's work waits for the
current stream at ``Lane.scope()``, the aggregator's reads of lane tensors
(the gather, the read view, ``state_dict``) ``join`` the lanes first and
record the tensors on the current stream, and current-stream tensors a
lane reads (the maps, a query chunk) are held for the lane.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from repro_torch.core import ddc as core_ddc
from repro_torch.kernels.ref import BIG, PAIR_CHUNK, eps_sq_f32, fma_f32
from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import compress
from repro_torch.serve import faults as faults_mod
from repro_torch.serve.cluster_service import (
    ClusterSet, ShardControlPlane, StreamConfig, _append, _host, _kill_mask, _set_row, _upload,
    empty_clusterset,
)

LANE_BUFFERS = ("_pts", "_mask", "_dense", "_glabels")


def require_devices(shards: int, device="cuda") -> torch.device:
    """The device the lanes go on.  One device holds any number of lanes
    (each a stream on a card), so the reference's one-device-per-shard
    rule has no counterpart; a device that does not exist is refused,
    with no fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend='dist': device {device!r} requested for {shards} lanes but CUDA is "
            f"not available; pass device='cpu' to run the lanes on the CPU")
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"backend='dist': device {device!r} does not exist "
            f"({torch.cuda.device_count()} card(s))")
    return dev


def lane_best(q: torch.Tensor, pts: torch.Tensor, mask: torch.Tensor,
              glabels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lane's query: per row of ``q`` (Q, 2), the least d2 =
    fma(dy, dy, dx·dx) over the lane's clustered live points and that
    point's global label (the first index on a tie); (BIG, label of slot
    0) when none is.  Rows go in chunks of ``PAIR_CHUNK`` pair tests."""
    ok = mask & (glabels >= 0)
    n = pts.shape[0]
    best = torch.empty((q.shape[0],), dtype=torch.float32, device=q.device)
    lab = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    rows = max(1, PAIR_CHUNK // max(n, 1))
    for r0 in range(0, q.shape[0], rows):
        qc = q[r0:r0 + rows]
        dx = qc[:, 0:1] - pts[None, :, 0]
        dy = qc[:, 1:2] - pts[None, :, 1]
        d2 = torch.where(ok[None, :], fma_f32(dy, dy, dx * dx), BIG)
        j = torch.argmin(d2, dim=1)
        best[r0:r0 + rows] = d2.gather(1, j[:, None])[:, 0]
        lab[r0:r0 + rows] = glabels[j]
    return best, lab


def fold_lanes(best: np.ndarray, lab: np.ndarray, eps: float) -> np.ndarray:
    """Fold lanes' (best d2, label) rows (L, Q) in ascending lane order
    with a strict ``<``, then mask at float32 eps²."""
    acc = np.full(best.shape[1:], BIG, np.float32)
    out = np.full(best.shape[1:], -1, np.int32)
    for d, lb in zip(best, lab):
        upd = d < acc
        acc = np.where(upd, d, acc)
        out = np.where(upd, lb, out)
    return np.where(acc <= np.float32(eps_sq_f32(eps)), out, -1).astype(np.int32)


def _row(stack: ClusterSet, j: int) -> ClusterSet:
    return ClusterSet(*(t[j] for t in stack))


def _payload(host: dict, j: int) -> dict:
    return {f: np.asarray(host[f][j]) for f in ClusterSet._fields}


class DistClusterService(ShardControlPlane):
    """Streaming DDC engine whose per-shard state lives on its own lane
    (see the module doc).  The public surface is ``ClusterService``'s; the
    difference is where each shard's work runs and that the exchange
    bytes are measured."""

    flavor = "dist"

    def __init__(self, scfg: StreamConfig, meter: core_ddc.CommMeter | None = None,
                 faults: faults_mod.FaultPlan | None = None, *, device="cuda"):
        dev = require_devices(scfg.shards, device)
        super().__init__(scfg, meter, faults=faults, device=dev)
        k, cap = scfg.shards, scfg.capacity
        self.lanes = mesh_mod.make_lane_mesh(k, self.device)
        empty = empty_clusterset(self.cfg, self.device)
        self._pts: List[torch.Tensor] = []
        self._mask: List[torch.Tensor] = []
        self._dense: List[torch.Tensor] = []
        self._glabels: List[torch.Tensor] = []
        for lane in self.lanes:
            with lane.scope():
                self._pts.append(torch.zeros((cap, 2), dtype=torch.float32, device=dev))
                self._mask.append(torch.zeros((cap,), dtype=torch.bool, device=dev))
                self._dense.append(torch.full((cap,), -1, dtype=torch.int32, device=dev))
                self._glabels.append(torch.full((cap,), -1, dtype=torch.int32, device=dev))
        # Lane i's last phase-1 ClusterSet (the reference's ``_batch_dev``
        # row); clean lanes carry it forward.
        self._rows: List[ClusterSet] = [empty] * k

    # -- data plane ---------------------------------------------------------

    def _append_chunk(self, shard, chunk, idx) -> None:
        with self.lanes[shard].scope():
            _append(self._pts[shard], self._mask[shard], _upload(chunk, self.device),
                    _upload(idx, self.device))

    def _kill_device(self, shard, kill) -> None:
        with self.lanes[shard].scope():
            _kill_mask(self._mask[shard], _upload(kill, self.device))

    def _restore_lane(self, shard, pts, live) -> None:
        with self.lanes[shard].scope():
            self._pts[shard] = _upload(np.asarray(pts, np.float32), self.device)
            self._mask[shard] = _upload(np.asarray(live, bool), self.device)

    def stacked(self, name: str) -> torch.Tensor:
        """A (K, …) copy of one per-lane buffer (``LANE_BUFFERS``) on the
        current stream, after the lanes' writes."""
        parts = getattr(self, name)
        mesh_mod.join(self.lanes, *parts)
        return torch.stack(parts)

    def _gather(self, lanes: Iterable[int]) -> Tuple[ClusterSet, dict]:
        """The aggregator's fetch of ``lanes``' ClusterSet rows in one
        gathered copy: the stacked rows on the current stream, and their
        host image (what the validation gate sees and the meter counts)."""
        idx = list(lanes)
        rows = [self._rows[i] for i in idx]
        mesh_mod.join([self.lanes[i] for i in idx], *(t for r in rows for t in r))
        stack = ClusterSet(*(torch.stack(ts) for ts in zip(*rows)))
        return stack, {f: _host(t) for f, t in zip(ClusterSet._fields, stack)}

    def _relabel(self) -> None:
        """Push each lane its slot-map row and relabel its points there."""
        maps = self._maps
        for i, lane in enumerate(self.lanes):
            with lane.scope():
                lane.hold(maps)
                dense = self._dense[i]
                self._glabels[i] = torch.where(self._mask[i] & (dense >= 0),
                                               maps[i][dense.clamp(min=0).long()], -1)

    # -- refresh (lane-local phase 1 + delta exchange + merge) --------------

    def refresh(self, mode: str | None = None, force: bool = False,
                track: bool | None = None):
        """Re-cluster the dirty lanes on their own streams, fetch only
        their ClusterSets to the aggregator, and re-close the cached
        merge.  Bit-identical to ``ClusterService.refresh`` on the same
        call sequence, the tracking fold included."""
        mode = mode or self.scfg.merge_mode
        k, cap = self.scfg.shards, self.scfg.capacity
        dirty = sorted(self._dirty - self._quarantined.keys())
        if not dirty and self._global is not None and not force:
            return self._global

        empty = empty_clusterset(self.cfg, self.device)
        for i in dirty:
            with self.lanes[i].scope():
                if self._count[i] == 0:
                    # Emptied lane: the cached all-invalid ClusterSet, no
                    # phase-1 work.
                    self._dense[i] = torch.full((cap,), -1, dtype=torch.int32,
                                                device=self.device)
                    self._rows[i] = empty
                else:
                    self._dense[i], self._rows[i] = core_ddc.local_phase(
                        self._pts[i], self._mask[i], self.cfg)

        # The crossing: a delta refresh fetches the dirty rows, a full
        # re-merge every lane's; the meter counts the fetched bytes.  Each
        # payload then passes the control plane's exchange (fault seam,
        # validation gate, retry, epoch fence); a retry fetches its row
        # again and is metered again.
        up_bytes = 0

        def refetch(i):
            nonlocal up_bytes
            stack, host = self._gather([i])
            up_bytes += compress.pytree_wire_bytes(host)
            return _payload(host, 0), _row(stack, 0)

        delta_ready = (self._hier.ready if self._hier is not None
                       else self._pair_d2 is not None)
        if mode == "delta" and delta_ready:
            first = {}
            if dirty:
                stack, host = self._gather(dirty)
                up_bytes += compress.pytree_wire_bytes(host)
                first = {i: (_payload(host, j), _row(stack, j)) for j, i in enumerate(dirty)}

            def produce(i, attempt):
                return first[i] if attempt == 0 and i in first else refetch(i)

            staged = self._exchange_deltas(dirty, produce)
        else:
            # All K lanes ship: one bulk fetch; the dirty rows pass the
            # gate, the clean rows refresh the mirror (equal values).
            stack, host = self._gather(range(k))
            up_bytes += compress.pytree_wire_bytes(host)

            def produce(i, attempt):
                return (_payload(host, i), _row(stack, i)) if attempt == 0 else refetch(i)

            staged = self._exchange_deltas(dirty, produce)
            if not self._quarantined and set(staged) == set(dirty):
                self._batch = ClusterSet(*(t.clone() for t in stack))
                self._local = [_row(stack, i) for i in range(k)]
            else:
                for i in range(k):
                    if i in self._quarantined or i in dirty:
                        continue    # dirty rows went through the gate
                    self._local[i] = _row(stack, i)
                    _set_row(self._batch, self._local[i], i)

        self._merge_and_meter(staged, mode, up_bytes=up_bytes)
        self._meter_maps_down(self._maps.numel() * self._maps.element_size())
        self._relabel()
        self._dirty -= set(staged)
        self._track_update(track)
        self.refreshes += 1
        self._publish_snapshot()
        return self._global

    # -- read path ----------------------------------------------------------

    def _read_view(self):
        # Copies: the lanes write their rings in place.
        return self.stacked("_pts"), self.stacked("_mask"), self.stacked("_glabels")

    def _query_sync(self, q: np.ndarray):
        """Lane-local (best d2, label) for each bbox-routed lane, folded
        on the host in ascending shard order with a strict ``<``;
        unscanned lanes give the identity (BIG, −1), which never wins."""
        qmax = self.scfg.max_queries
        degraded = False
        scanned: set = set()
        out = np.empty((len(q),), np.int32)
        for off in range(0, len(q), qmax):
            chunk = q[off:off + qmax]
            nq = len(chunk)
            scan = self._route(chunk)
            degraded |= self._route_degraded
            sel = [int(s) for s in np.nonzero(scan)[0]]
            scanned.update(sel)
            if not sel:
                out[off:off + nq] = -1
                continue
            qd = _upload(chunk, self.device)
            best, lab = [], []
            for s in sel:
                lane = self.lanes[s]
                with lane.scope():
                    lane.hold(qd)
                    b, lb = lane_best(qd, self._pts[s], self._mask[s], self._glabels[s])
                best.append(b)
                lab.append(lb)
            mesh_mod.join([self.lanes[s] for s in sel], *best, *lab)
            out[off:off + nq] = fold_lanes(_host(torch.stack(best)), _host(torch.stack(lab)),
                                           self.cfg.eps)
        return out, degraded, scanned

    # -- introspection -------------------------------------------------------

    def _live_buffers(self):
        return tuple(_host(self.stacked(n)) for n in ("_pts", "_mask", "_glabels"))

    # -- snapshot / restore --------------------------------------------------

    def state_dict(self) -> Tuple[dict, dict]:
        """``ClusterService.state_dict``'s arrays and manifest, so a
        snapshot of either engine, of either package, restores into
        either."""
        arrays = {"pts": _host(self.stacked("_pts")), "mask": _host(self.stacked("_mask")),
                  "dense": _host(self.stacked("_dense"))} | self._mirror_arrays()
        return arrays, self._mirror_manifest()

    @classmethod
    def from_state(cls, scfg: StreamConfig, arrays: dict, manifest: dict,
                   meter: core_ddc.CommMeter | None = None,
                   faults: faults_mod.FaultPlan | None = None, *,
                   device="cuda") -> "DistClusterService":
        """Rebuild a service from ``state_dict`` output of either engine,
        of either package; it resumes bit-identically."""
        svc = cls(scfg, meter=meter, faults=faults, device=device)
        dev = svc.device
        for i, lane in enumerate(svc.lanes):
            with lane.scope():
                svc._pts[i] = _upload(np.asarray(arrays["pts"][i], np.float32), dev)
                svc._mask[i] = _upload(np.asarray(arrays["mask"][i], bool), dev)
                svc._dense[i] = _upload(np.asarray(arrays["dense"][i], np.int32), dev)
        svc._restore_mirrors(arrays, manifest)
        svc._restore_batch(arrays)
        svc._rows = list(svc._local)
        if svc._restore_global(arrays, manifest):
            svc._relabel()
            svc._publish_snapshot()
        return svc
