"""Segment layout — the gp_segment_configuration analog, on one card.

The JAX package runs a distributed plan as one ``shard_map`` program over
a ``jax.sharding.Mesh`` whose ``seg`` axis holds one device per segment.
The port runs every segment on ONE CUDA device: a partitioned table is a
``(n_segments, capacity)`` tensor and segment ``s`` works on its row
views ``t[s]`` (exec/dist_executor.py). The axis keeps the reference's
name so plans and telemetry read the same.

Segment SLOTS stand in for the reference's devices. The reference's
``jax.devices()`` is the pool a survivor restriction names ids in; the
port's pool is the cluster's healthy slot count (parallel/health.py
``slot_count``), so a restriction ``[0, 1, 2, 4, 5, 6, 7]`` of an
8-segment cluster that lost slot 3 places 7 segments over the survivors
as the reference meshes 7 segments over its 7 live devices. A degrade or
failover shrinks the epoch's segment count, not the pool, so an id below
the pool stays valid and slots can come back. ``MAX_SLOTS`` bounds the
pool: the one card's stand-in for the visible device count that the
reference's ``TopologyManager.begin`` refuses to expand past.

``HostTopology`` is the host → segment layout the motion layer's
two-level gate consults. One card is one host, so the derivation always
yields a single host: the two-level (hierarchical) motion never fires,
as in the reference on a one-host mesh. ``CBTPU_FORCE_HOSTS`` (the
reference's simulated multi-host split) and multi-host
``init_distributed`` are not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

SEG_AXIS = "seg"

# The most segment slots one card hosts. Every segment is a set of row
# views of the card's tensors and a gang step lowers each segment in turn
# on the host, so the limit is a design constant, not a device count:
# a 64-segment tile step already costs eight times the 8-segment one's
# host dispatch. TopologyManager.begin refuses a larger epoch.
MAX_SLOTS = 64


class DeviceRestrictionError(RuntimeError):
    """A ``device_ids`` restriction named devices the layout cannot use.

    ``kind`` is ``"stale"`` (an id at or past the live device count: an
    out-of-date survivor list) or ``"invalid"`` (a negative or duplicate
    id: the list itself is malformed)."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


def _check_device_ids(device_ids, n_slots: int) -> None:
    """A survivor restriction against the slot pool: negative or
    duplicate ids are malformed, ids at or past the pool are stale."""
    ids = list(device_ids)
    bad = [i for i in ids if i < 0]
    if bad or len(set(ids)) != len(ids):
        raise DeviceRestrictionError(
            "invalid", f"device restriction {ids} has negative or "
            "duplicate ids")
    stale = [i for i in ids if i >= n_slots]
    if stale:
        raise DeviceRestrictionError(
            "stale", f"device ids {stale} are past the {n_slots} segment "
            "slot(s)")


@dataclass(frozen=True)
class HostTopology:
    """Host → segment layout (immutable, derived)."""

    n_segments: int
    # host -> tuple of global segment indices it owns (ascending)
    segs_by_host: tuple

    @property
    def n_hosts(self) -> int:
        return len(self.segs_by_host)


def host_topology(n_segments: int, device_ids=None,
                  n_slots: int | None = None) -> HostTopology:
    """The layout of ``n_segments`` segments on this process's card: one
    host owning every segment. ``device_ids`` (a survivor restriction) is
    checked against the slot pool ``n_slots`` (default: ``n_segments``)
    as the reference checks it against its device list."""
    if os.environ.get("CBTPU_FORCE_HOSTS"):
        raise NotImplementedError(
            "CBTPU_FORCE_HOSTS (a simulated multi-host split) is not yet "
            "ported to cloudberry_tpu_torch (ROADMAP Queue A: the "
            "hierarchical transport)")
    if n_segments > MAX_SLOTS:
        raise RuntimeError(
            f"config asks for {n_segments} segments but one card hosts "
            f"at most {MAX_SLOTS} segment slots")
    if device_ids is not None:
        _check_device_ids(device_ids,
                          n_segments if n_slots is None else n_slots)
    return HostTopology(n_segments, (tuple(range(n_segments)),))
