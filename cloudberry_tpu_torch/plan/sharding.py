"""Sharding — the CdbPathLocus analog (cdbpathlocus.h:41-68).

Every plan node carries one; the distribution pass uses it exactly the way
cdbpath_motion_for_join (cdbpath.c:1346) uses loci: decide whether an op can
run where its inputs are, or needs a Motion.

Mapping from the reference's locus taxonomy:
- Hashed(keys)      ← CdbLocusType_Hashed (rows hash-distributed on keys)
- Replicated        ← CdbLocusType_SegmentGeneral/Replicated (full copy per segment)
- Singleton         ← CdbLocusType_Entry/SingleQE (one place: the coordinator slot)
- General           ← CdbLocusType_General (constant/computed anywhere, e.g. 1-row)
- Strewn            ← CdbLocusType_Strewn (partitioned, no known key)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Sharding:
    kind: str                      # 'hashed' | 'replicated' | 'singleton' | 'general' | 'strewn'
    keys: tuple[str, ...] = ()     # output column names, for 'hashed'

    def __str__(self):
        if self.kind == "hashed":
            return f"hashed({', '.join(self.keys)})"
        return self.kind

    @property
    def is_partitioned(self) -> bool:
        return self.kind in ("hashed", "strewn")

    @staticmethod
    def hashed(*keys: str) -> "Sharding":
        return Sharding("hashed", tuple(keys))

    @staticmethod
    def replicated() -> "Sharding":
        return Sharding("replicated")

    @staticmethod
    def singleton() -> "Sharding":
        return Sharding("singleton")

    @staticmethod
    def general() -> "Sharding":
        return Sharding("general")

    @staticmethod
    def strewn() -> "Sharding":
        return Sharding("strewn")


def hashed_compatible(s: Sharding, required_keys: list[str]) -> bool:
    """True if rows already colocated for grouping/joining on required_keys:
    the sharding keys must be a SUBSET of the required keys (then equal
    required-tuples hash to the same segment)."""
    return s.kind == "hashed" and len(s.keys) > 0 and set(s.keys) <= set(required_keys)
