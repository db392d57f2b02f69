"""The motion transport of one card — the ic_modules.c vtable analog.

The JAX package's motions are collectives over a device mesh
(``all_gather`` / ``all_to_all`` / ``psum`` / ``pmax`` on the ``seg``
axis, parallel/transport.py there). On one card every segment's buffer
already lies in the same device memory, so each collective takes the
list of all segments' values (segment order) and returns what every
segment receives — with the reference's exact buffer layout:

- ``all_gather`` (``tiled=True``): the segments' blocks concatenated in
  segment order; every segment receives the same tensor.
- ``all_to_all`` (``split_axis=0, concat_axis=0, tiled=False``): source
  ``s`` sends ``x_s[d]`` to destination ``d``; destination ``d`` receives
  the blocks of sources 0..nseg-1 in source order. On one card that is
  an index transpose of the ``(src, dst, B, W)`` stack.
- ``psum`` / ``pmax``: the reduction, the same value for every segment.

Unfilled slots stay all-zero and unpack as invalid (exec/kernels.py
``pack_wire``), so received buffers equal the reference's row for row —
float sums after a motion add in the reference's order.

Not ported (ROADMAP Queue A): the ring transport (``backend="ring"``),
the hierarchical two-level transport, and ``CBTPU_FORCE_HOSTS``.
"""

from __future__ import annotations

import torch


class OneCardCollectives:
    """The segments' collectives as tensor ops on one device."""

    def all_gather(self, xs: list) -> torch.Tensor:
        """Concatenation in segment order (every segment receives it)."""
        return torch.cat(list(xs))

    def all_to_all(self, xs: list) -> list:
        """xs[s]: (nseg, ...) blocks of source s by destination → one
        (nseg, ...) received buffer per destination, by source."""
        return list(torch.stack(list(xs)).transpose(0, 1).contiguous())

    def psum(self, xs: list) -> torch.Tensor:
        return torch.stack([torch.as_tensor(x) for x in xs]).sum(0)

    def pmax(self, xs: list) -> torch.Tensor:
        return torch.stack([torch.as_tensor(x) for x in xs]).amax(0)


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not yet ported to cloudberry_tpu_torch (ROADMAP "
        "Queue A: the ring and hierarchical transports)")


def make_transport(backend: str, n_segments: int, device_ids=None,
                   n_slots: int | None = None):
    """The transport named by ``interconnect.backend``: ``"xla"`` is the
    one-card exchange, flat as the reference's on a one-host layout;
    ``"ring"`` and a forced multi-host split (``CBTPU_FORCE_HOSTS``,
    raised by ``mesh.host_topology``) are not ported. ``device_ids`` and
    ``n_slots``: the session's survivor restriction and slot pool, checked
    as the reference's segment mesh checks its devices — the survivors
    must cover the segments."""
    from cloudberry_tpu_torch.parallel.mesh import host_topology

    host_topology(n_segments, device_ids, n_slots)
    if device_ids is not None and len(device_ids) < n_segments:
        raise RuntimeError(
            f"config asks for {n_segments} segments but only "
            f"{len(device_ids)} segment slots survive")
    if backend == "xla":
        return OneCardCollectives()
    if backend == "ring":
        _not_ported("the ring transport (interconnect.backend='ring')")
    raise ValueError(f"unknown interconnect backend {backend!r} "
                     "(known: xla, ring)")
