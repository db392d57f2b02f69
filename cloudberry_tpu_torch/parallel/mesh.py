"""Segment layout — the gp_segment_configuration analog, on one card.

The JAX package runs a distributed plan as one ``shard_map`` program over
a ``jax.sharding.Mesh`` whose ``seg`` axis holds one device per segment.
The port runs every segment on ONE CUDA device: a partitioned table is a
``(n_segments, capacity)`` tensor and segment ``s`` works on its row
views ``t[s]`` (exec/dist_executor.py). The axis keeps the reference's
name so plans and telemetry read the same.

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


class DeviceRestrictionError(RuntimeError):
    """A ``device_ids`` restriction named devices the layout cannot use.

    ``kind`` is ``"stale"`` (an id at or past the live device count: an
    out-of-date survivor list) or ``"invalid"`` (a negative or duplicate
    id: the list itself is malformed)."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


def _check_device_ids(device_ids, n_devices: int) -> None:
    ids = list(device_ids)
    bad = [i for i in ids if i < 0]
    if bad or len(set(ids)) != len(ids):
        raise DeviceRestrictionError(
            "invalid", f"device restriction {ids} has negative or "
            "duplicate ids")
    stale = [i for i in ids if i >= n_devices]
    if stale:
        raise DeviceRestrictionError(
            "stale", f"device ids {stale} are past the {n_devices} live "
            "device(s)")


@dataclass(frozen=True)
class HostTopology:
    """Host → segment layout (immutable, derived)."""

    n_segments: int
    # host -> tuple of global segment indices it owns (ascending)
    segs_by_host: tuple

    @property
    def n_hosts(self) -> int:
        return len(self.segs_by_host)


def host_topology(n_segments: int, device_ids=None) -> HostTopology:
    """The layout of ``n_segments`` segments on this process's card: one
    host owning every segment. ``device_ids`` is checked against the one
    device as the reference checks it against its device list."""
    if os.environ.get("CBTPU_FORCE_HOSTS"):
        raise NotImplementedError(
            "CBTPU_FORCE_HOSTS (a simulated multi-host split) is not yet "
            "ported to cloudberry_tpu_torch (ROADMAP Queue A: the "
            "hierarchical transport)")
    if device_ids is not None:
        _check_device_ids(device_ids, 1)
    return HostTopology(n_segments, (tuple(range(n_segments)),))
