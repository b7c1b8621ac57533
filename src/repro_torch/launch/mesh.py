"""Lane layouts for the device-resident serve engine.

Counterpart of the reference package's ``launch/mesh.py::make_host_mesh``.
The reference lays K shards over a K-device mesh axis, one shard a device.
The port lays K lanes on one torch device: on a card each lane owns a
``torch.cuda.Stream``, so one lane's work is ordered only against its own
and against what the device's current stream issued before it; on the CPU
no lane has a stream and work runs in the order it is issued.  One card
holds any number of lanes.  (``make_production_mesh``, the LM stack's
multi-card mesh, comes with ROADMAP A10 item 6.)

Cross-stream rules the lanes' users keep:

* ``Lane.scope()`` makes the lane's stream wait for everything the
  current stream has issued, then issues the block's work on the lane.
  So a lane never reads a tensor before the current stream has finished
  writing it, and a block a lane reuses from the allocator was released
  by readers that were issued before.
* ``join(lanes)`` makes the current stream wait for the lanes' work
  before it reads what they wrote; ``Lane.hold(t)`` records a current-
  stream tensor as used by the lane, so the caching allocator does not
  hand its block out again before the lane's reads of it are done.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Lane:
    """One shard's lane: its index, device and (on a card) stream."""

    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]

    def scope(self):
        """Context that issues its work on this lane, after all that the
        device's current stream issued before it."""
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def hold(self, *tensors: torch.Tensor) -> None:
        """Mark tensors allocated on another stream as read by this lane."""
        if self.stream is not None:
            for t in tensors:
                t.record_stream(self.stream)


def make_lane_mesh(n: int, device="cuda") -> Tuple[Lane, ...]:
    """``n`` lanes on ``device``: each with a stream of its own on a card,
    none on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return tuple(Lane(i, dev, torch.cuda.Stream(dev) if dev.type == "cuda" else None)
                 for i in range(n))


def join(lanes: Sequence[Lane], *tensors: torch.Tensor) -> None:
    """Make the current stream wait for ``lanes``' work, and record
    ``tensors`` (written on those lanes) as read by the current stream."""
    streams = [lane.stream for lane in lanes if lane.stream is not None]
    if not streams:
        return
    cur = torch.cuda.current_stream(lanes[0].device)
    for s in streams:
        cur.wait_stream(s)
    for t in tensors:
        t.record_stream(cur)
