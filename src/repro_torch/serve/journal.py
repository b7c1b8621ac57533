"""Bounded write-ahead ingest/evict journal for the stream engine.

A copy of the reference package's ``serve/journal.py`` (NumPy only):
its mirrors have the reference's dtypes, so a state saved by either
package restores in the other.

The control plane (DESIGN.md §10) already mirrors every ring-buffer
decision on the host — slot choice, live mask, TTL stamps, seq numbers —
so a write-ahead log costs almost nothing: we record each ingest chunk
(slots + points + stamps) and each kill mask *as they are applied to the
mirrors*, per shard, on top of a base snapshot of the mirrors.  Replay
is then a pure host-side fold: base copy + entries, in order, lands
bit-exactly on the current mirrors — which is exactly the state a lost
device lane needs re-uploaded to rejoin after quarantine.

The journal is bounded: once a shard accumulates more than
``limit`` entries it is compacted (base := current mirrors, entries
cleared), so memory stays O(shards · capacity) regardless of stream
length.  ``entries_total`` is a monotonic counter surfaced in
``stats()`` so journal pressure is observable.

numpy-only by design: replay happens on the host, never inside jit.
"""
from __future__ import annotations

import numpy as np


class Journal:
    def __init__(self, shards: int, capacity: int, limit: int = 1024):
        self.shards = int(shards)
        self.capacity = int(capacity)
        self.limit = max(1, int(limit))
        self._base = [self._empty_base(self.capacity)
                      for _ in range(self.shards)]
        self._entries: list = [[] for _ in range(self.shards)]
        self.entries_total = 0      # monotonic, survives compaction
        self.compactions = 0

    @staticmethod
    def _empty_base(cap: int) -> dict:
        # Matches the control plane's freshly-built mirrors bit-for-bit.
        return {
            "pts": np.zeros((cap, 2), np.float32),
            "live": np.zeros((cap,), bool),
            "ts": np.full((cap,), -np.inf, np.float64),
            "seq": np.full((cap,), -1, np.int64),
        }

    def entry_count(self, shard: int) -> int:
        return len(self._entries[shard])

    def record_ingest(self, shard: int, slots: np.ndarray, pts: np.ndarray,
                      ts: np.ndarray, seqs: np.ndarray) -> None:
        """Log one ingest chunk: ring slots written, the points, and the
        authoritative ts/seq stamps (seq-stamped ordering)."""
        self._entries[shard].append((
            "ingest",
            np.asarray(slots, np.int64).copy(),
            np.asarray(pts, np.float32).copy(),
            np.asarray(ts, np.float64).copy(),
            np.asarray(seqs, np.int64).copy(),
        ))
        self.entries_total += 1

    def record_kill(self, shard: int, kill: np.ndarray) -> None:
        """Log one eviction: the slots whose liveness was cleared."""
        self._entries[shard].append(
            ("kill", np.nonzero(np.asarray(kill, bool))[0].copy()))
        self.entries_total += 1

    def needs_compaction(self, shard: int) -> bool:
        return len(self._entries[shard]) > self.limit

    def compact(self, shard: int, pts, live, ts, seq) -> None:
        """Re-base the shard's log on the current mirrors (the caller's
        arrays ARE the replay target, so this is always safe)."""
        self._base[shard] = {
            "pts": np.asarray(pts, np.float32).copy(),
            "live": np.asarray(live, bool).copy(),
            "ts": np.asarray(ts, np.float64).copy(),
            "seq": np.asarray(seq, np.int64).copy(),
        }
        self._entries[shard] = []
        self.compactions += 1

    def replay(self, shard: int):
        """Fold base + entries into the shard's ring-buffer state.
        Returns ``(pts, live, ts, seq)`` host arrays."""
        base = self._base[shard]
        pts = base["pts"].copy()
        live = base["live"].copy()
        ts = base["ts"].copy()
        seq = base["seq"].copy()
        for entry in self._entries[shard]:
            if entry[0] == "ingest":
                _, slots, chunk, cts, cseq = entry
                pts[slots] = chunk
                live[slots] = True
                ts[slots] = cts
                seq[slots] = cseq
            else:   # kill
                live[entry[1]] = False
        return pts, live, ts, seq
