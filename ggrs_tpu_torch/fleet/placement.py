"""Consistent-hash placement for the fleet layer (DESIGN.md §16).

The port's copy of ``ggrs_tpu/fleet/placement.py``.

Matches hash onto a ring of virtual points (``replicas`` per shard, md5 —
stable across processes and Python hash randomization), so the owner of a
match moves only when shards join or leave, and every match has a
deterministic *preference order* of fallback shards: admission walks it
when the owner refuses (full / draining / unhealthy), and failover walks
it when the owner is dead.  Placement is pure policy — it never touches a
pool; the :class:`~ggrs_tpu_torch.fleet.supervisor.ShardSupervisor` combines it
with capacity-aware admission checks driven by the obs gauges.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Iterator, List, Tuple


def _point(key: str) -> int:
    """Stable 64-bit ring coordinate (md5 — not security, just uniform and
    identical across processes, unlike ``hash()``)."""
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over shard ids.

    ``replicas`` virtual points per shard smooth the load split; 64 keeps
    the max/min owner imbalance under ~30% for small fleets, which the
    capacity-aware admission check absorbs.
    """

    def __init__(self, shard_ids: Iterable[str] = (),
                 replicas: int = 64) -> None:
        self._replicas = replicas
        self._points: List[Tuple[int, str]] = []
        self._shards: set = set()
        for sid in shard_ids:
            self.add(sid)

    def add(self, shard_id: str) -> None:
        if shard_id in self._shards:
            return
        self._shards.add(shard_id)
        for r in range(self._replicas):
            self._points.append((_point(f"{shard_id}#{r}"), shard_id))
        self._points.sort()

    def remove(self, shard_id: str) -> None:
        if shard_id not in self._shards:
            return
        self._shards.discard(shard_id)
        self._points = [p for p in self._points if p[1] != shard_id]

    def __len__(self) -> int:
        return len(self._shards)

    def __contains__(self, shard_id: str) -> bool:
        return shard_id in self._shards

    def shards(self) -> List[str]:
        return sorted(self._shards)

    def owner(self, match_id: str) -> str:
        """The match's home shard: the first ring point at or after its
        hash (wrapping)."""
        for sid in self.preference(match_id):
            return sid
        raise LookupError("empty hash ring")

    def preference(self, match_id: str) -> Iterator[str]:
        """Every shard, ordered by the ring walk from the match's hash —
        the owner first, then the deterministic fallback order admission
        retries and failover re-placement follow."""
        if not self._points:
            return
        start = bisect.bisect_left(self._points, (_point(match_id), ""))
        seen = set()
        n = len(self._points)
        for i in range(n):
            sid = self._points[(start + i) % n][1]
            if sid not in seen:
                seen.add(sid)
                yield sid
