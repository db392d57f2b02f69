"""The motion transports of one card — the ic_modules.c vtable analog.

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
  the blocks of sources 0..nseg-1 in source order.
- ``psum`` / ``pmax``: the reduction, the same value for every segment.

Unfilled slots stay all-zero and unpack as invalid (exec/kernels.py
``pack_wire``), so received buffers equal the reference's row for row —
float sums after a motion add in the reference's order.

Three transports implement that interface, as in the reference:

- ``OneCardCollectives`` (``interconnect.backend="xla"``): an all_to_all
  is one index transpose of the ``(src, dst, B, W)`` stack.
- ``RingCollectives`` (``backend="ring"``): every collective composed
  from shifts of the stacked ``(nseg, ...)`` tensor along the segment
  axis, the reference's ``ppermute`` rings — a second, independent
  exchange whose results must equal the first bit for bit.
- ``HierarchicalCollectives``: the topology-aware two-level exchange over
  a uniform contiguous ``HostTopology`` (parallel/mesh.py; on one card a
  simulated split, ``CBTPU_FORCE_HOSTS``): an intra-host hop, ONE
  aggregated inter-host hop at the host rung, an intra-host scatter.
  Every ``ppermute`` of the reference is one permutation of the segment
  dimension here, counted in ``launches``.

Every per-segment branch of the reference (``axis_index``) is computed
over the stacked segment dimension in one set of tensor ops; no
transport loops over segments on the host.

In a cluster of processes (parallel/mesh.py ``init_distributed``) each
process owns a contiguous range of segments, whose size may differ
between processes (``mesh.segment_owners``), and the contract becomes
"this process's segments in, this process's segments out": the lists
hold the local segments' values in segment order, and every value a
segment receives is the one it would receive in one process. In one
process local means all and nothing changes. ``ProcessCollectives`` is
the flat exchange across processes (``torch.distributed`` over gloo, CUDA
blocks staged through pinned host memory); the ring's shifts and the
two-level transport's permutations cross the process boundary where a
(source, destination) pair does (``_permute``), and stay index
operations where both segments are local. Every transport counts the
bytes it hands to ``torch.distributed`` for other processes in
``dist_bytes``, and appends each redistribute's to ``exchanges`` (the
executor stamps the record with the plan's rungs and row width), the
reading ``two_level_wire_model`` and ``flat_wire_model`` describe.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist


# the two-level transport's static index tables (segment ids, the
# permutations, hop 1's lane layout), built once per (segments, hosts,
# table, device) for every transport of that layout
_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()
_TABLES_MAX = 256


def _stack(xs) -> torch.Tensor:
    return torch.stack([torch.as_tensor(x) for x in xs])


# ------------------------------------------------- across processes

def _wire_view(x: torch.Tensor):
    """(a gloo-ready host tensor, the function that brings a received
    host tensor back): bool rides as uint8, and a CUDA tensor is staged
    through pinned host memory."""
    back_dtype = x.dtype
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous()
    if x.device.type != "cpu":
        dev = x.device
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
    else:
        dev = None
        host = x

    def back(h: torch.Tensor) -> torch.Tensor:
        if dev is not None:
            h = h.to(dev)
        return h.to(back_dtype) if back_dtype == torch.bool else h
    return host, back


def cluster_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced over the cluster's processes (``"sum"`` or
    ``"max"``); ``t`` itself in one process."""
    from cloudberry_tpu_torch.parallel.mesh import process_count

    if process_count() == 1:
        return t
    host, back = _wire_view(t)
    host = host.clone() if host.data_ptr() == t.data_ptr() else host
    dist.all_reduce(host, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    return back(host)


def cluster_all(flag: bool) -> bool:
    """``flag`` held on every process of the cluster (``flag`` itself
    in one process): a local decision agreed before any process acts on
    it."""
    from cloudberry_tpu_torch.parallel.mesh import process_count

    if process_count() == 1:
        return flag
    return bool(cluster_reduce(torch.tensor([int(not flag)]), "max") == 0)


def cluster_sizes_agree(sizes: tuple, what: str) -> None:
    """Raise unless every process reports the same ``sizes`` (the counts
    of values batched reductions are about to line up by position)."""
    from cloudberry_tpu_torch.parallel.mesh import process_count

    if process_count() == 1:
        return
    mine = torch.tensor(list(sizes), dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(every, mine)
    got = [tuple(int(x) for x in v) for v in every]
    if len(set(got)) != 1:
        raise RuntimeError(
            f"the processes disagree on the number of {what}: {got}")


class _PermPlan:
    """One permutation's moves for one process: the local pairs by index
    (``full``: every local segment receives, one gather), the rows sent
    to and received from other processes in ``all_to_all_single`` order,
    and their per-process counts; ``cross``: some pair of the cluster
    crosses a process boundary (every process then issues the call)."""

    def __init__(self, perm: tuple, owners: tuple, rank: int, device):
        from cloudberry_tpu_torch.parallel.mesh import owner_ranges

        rngs = owner_ranges(owners)
        lo, nl, P = rngs[rank].start, len(rngs[rank]), len(rngs)
        mine = [(s - lo, d - lo) for s, d in perm
                if owners[s] == rank and owners[d] == rank]
        send = sorted((owners[d], k, s - lo) for k, (s, d) in enumerate(perm)
                      if owners[s] == rank and owners[d] != rank)
        recv = sorted((owners[s], k, d - lo) for k, (s, d) in enumerate(perm)
                      if owners[d] == rank and owners[s] != rank)

        def t(v):
            return torch.as_tensor(np.asarray(v, dtype=np.int64),
                                   device=device)
        self.cross = any(owners[s] != owners[d] for s, d in perm)
        self.full = len(mine) == nl and not self.cross
        if self.full:
            # every segment receives: one gather by the inverse map
            inv = np.argsort(np.asarray([d for _, d in mine]))
            self.gather = t(np.asarray([s for s, _ in mine])[inv])
        self.lsrc, self.ldst = t([a for a, _ in mine]), t([b for _, b in mine])
        self.n_local = len(mine)
        self.sidx = t([i for _, _, i in send])
        self.ridx = t([i for _, _, i in recv])
        self.n_recv = len(recv)
        self.scnt = np.bincount([q for q, _, _ in send], minlength=P).tolist()
        self.rcnt = np.bincount([q for q, _, _ in recv], minlength=P).tolist()


_PLANS: dict = {}


def _permute(x: torch.Tensor, perm, owners: tuple, rank: int):
    """One permutation of the segment dimension: segment ``dst`` receives
    segment ``src``'s value for every (src, dst) pair of ``perm`` (global
    segment ids); segments that receive nothing read zeros (ppermute's
    rule). ``x`` holds the segments ``owners`` gives process ``rank``
    (every segment in one process). Pairs whose segments are both local
    move by index; the others go through ONE ``all_to_all_single``, which
    every process issues (or skips, when no pair crosses) alike. Returns
    (the received values, the bytes handed to torch.distributed)."""
    perm = tuple(perm)
    key = (perm, owners, rank, str(x.device))
    with _TABLES_LOCK:
        plan = _PLANS.get(key)
    if plan is None:
        plan = _PermPlan(perm, owners, rank, x.device)
        with _TABLES_LOCK:
            if len(_PLANS) >= _TABLES_MAX:
                _PLANS.pop(next(iter(_PLANS)))
            _PLANS[key] = plan
    if plan.full:
        return x.index_select(0, plan.gather), 0
    out = torch.zeros_like(x)
    if plan.n_local:
        out.index_copy_(0, plan.ldst, x.index_select(0, plan.lsrc))
    if not plan.cross:
        return out, 0
    host, back = _wire_view(x.index_select(0, plan.sidx))
    got = torch.empty((plan.n_recv,) + tuple(host.shape[1:]),
                      dtype=host.dtype)
    dist.all_to_all_single(got, host, plan.rcnt, plan.scnt)
    if plan.n_recv:
        out.index_copy_(0, plan.ridx, back(got))
    return out, host.numel() * host.element_size()


class ProcessCollectives:
    """The flat exchange of a cluster of P processes, process p owning the
    contiguous segment range ``owners`` gives it (sizes may differ): the
    lists in and out hold the local segments' values.

    - ``all_gather``: ``dist.all_gather`` of the local concatenation, each
      process's block padded to the largest process's (gloo gathers equal
      tensors) and trimmed on arrival;
    - ``all_to_all``: the local (S, nseg, B, ...) stack by destination
      goes through ``dist.all_to_all_single`` with per-process split sizes
      (destination process, then local source), then is rearranged to one
      buffer per local destination, by source;
    - ``psum`` / ``pmax``: the local reduction, then ``dist.all_reduce``.
    """

    name = "xla"

    def __init__(self, owners: tuple, rank: int):
        from cloudberry_tpu_torch.parallel.mesh import owner_ranges

        rngs = owner_ranges(owners)
        self.owners = tuple(owners)
        self.rank = rank
        self.n = len(owners)
        self.P = len(rngs)
        self.sizes = [len(r) for r in rngs]
        self.local = rngs[rank]
        self.lo, self.nl = self.local.start, len(self.local)
        # bytes handed to torch.distributed for the other processes
        self.dist_bytes = 0
        # one record per all_to_all: its bytes for other processes (the
        # executor adds the plan's rung and row width)
        self.exchanges: list = []

    @property
    def total_dist_bytes(self) -> int:
        return self.dist_bytes

    def all_gather(self, xs: list, unsigned: bool = False) -> torch.Tensor:
        host, back = _wire_view(torch.cat(list(xs)))
        per = host.shape[0] // self.nl          # rows of one segment
        most = max(self.sizes) * per
        if host.shape[0] < most:
            host = torch.cat([host, host.new_zeros(
                (most - host.shape[0],) + tuple(host.shape[1:]))])
        parts = [torch.empty_like(host) for _ in range(self.P)]
        dist.all_gather(parts, host)
        self.dist_bytes += host.numel() * host.element_size() * (self.P - 1)
        return back(torch.cat([p[:n * per]
                               for p, n in zip(parts, self.sizes)]))

    def all_to_all(self, xs: list) -> list:
        x = _stack(xs)                         # (S_src, nseg_dst, ...)
        nl, sizes = self.nl, self.sizes
        tail = tuple(x.shape[2:])
        send, back = _wire_view(x.transpose(0, 1))   # (nseg_dst, S_src, ...)
        send = send.reshape(self.n * nl, -1)
        recv = torch.empty((nl * self.n, send.shape[1]), dtype=send.dtype)
        dist.all_to_all_single(recv, send, [nl * c for c in sizes],
                               [c * nl for c in sizes])
        # the blocks handed over for other processes' destinations
        nbytes = (self.n - nl) * nl * send.shape[1] * send.element_size()
        self.dist_bytes += nbytes
        self.exchanges.append({"op": "all_to_all", "bytes": nbytes})
        # from process q: (local destination, q's source) blocks
        out = torch.cat([blk.reshape((nl, c) + tail) for blk, c in
                         zip(back(recv).split([nl * c for c in sizes]),
                             sizes)], dim=1)
        return list(out)

    def _reduce(self, local: torch.Tensor, op: str) -> torch.Tensor:
        self.dist_bytes += local.numel() * local.element_size() \
            * (self.P - 1)
        return cluster_reduce(local, op)

    def psum(self, xs: list) -> torch.Tensor:
        return self._reduce(_stack(xs).sum(0), "sum")

    def pmax(self, xs: list) -> torch.Tensor:
        return self._reduce(_stack(xs).amax(0), "max")


class OneCardCollectives:
    """The segments' collectives as tensor ops on one device (the
    reference's XLA-native collectives)."""

    name = "xla"

    def all_gather(self, xs: list, unsigned: bool = False) -> torch.Tensor:
        """Concatenation in segment order (every segment receives it).
        ``unsigned``: the reference's payload is unsigned (the packed
        wire, u64 keys); only the two-level transport reads it."""
        return torch.cat(list(xs))

    def all_to_all(self, xs: list) -> list:
        """xs[s]: (nseg, ...) blocks of source s by destination → one
        (nseg, ...) received buffer per destination, by source."""
        return list(_stack(xs).transpose(0, 1).contiguous())

    def psum(self, xs: list) -> torch.Tensor:
        return _stack(xs).sum(0)

    def pmax(self, xs: list) -> torch.Tensor:
        return _stack(xs).amax(0)


class RingCollectives:
    """Shift-composed collectives: all_gather, psum and pmax are true
    rings (n−1 neighbour shifts with accumulation); all_to_all rotates
    each round's blocks by distance k. A shift is one permutation of the
    stacked tensor along the segment axis (``_permute``, the two-level
    transport's too): segment i sends to i+by.

    ``chunks`` > 1 splits each all_to_all block along its ROW axis into
    that many contiguous slices, one shift per (hop, slice) — the
    reference's software-pipelined ring. An indivisible count falls back
    to whole-block hops. Chunking never changes results. ``launches``
    counts the shifts, one per reference ``ppermute``.

    Across processes (``owners`` of the segment layout, this process
    ``rank``) the stacked dimension holds this process's segments only:
    a shift moves the pairs inside a process by index and the ones that
    cross a block's edge through one ``all_to_all_single``;
    a reduction's replicated value is segment 0's accumulation, as in one
    process, broadcast from its owner."""

    name = "ring"

    def __init__(self, n: int, chunks: int = 1, owners=None,
                 rank: int = 0):
        from cloudberry_tpu_torch.parallel.mesh import owner_ranges

        self.n = n
        self.chunks = max(int(chunks), 1)
        self.owners = tuple(owners) if owners is not None else (0,) * n
        self.rank = rank
        rngs = owner_ranges(self.owners)
        self.P = len(rngs)
        self.local = rngs[rank]
        self.launches = 0
        # bytes handed to torch.distributed for the other processes, and
        # one record per all_to_all (the executor stamps rungs and width)
        self.dist_bytes = 0
        self.exchanges: list = []

    @property
    def total_dist_bytes(self) -> int:
        return self.dist_bytes

    def _shift(self, x: torch.Tensor, by: int = 1) -> torch.Tensor:
        self.launches += 1
        n = self.n
        out, nbytes = _permute(x, tuple((s, (s + by) % n) for s in range(n)),
                               self.owners, self.rank)
        self.dist_bytes += nbytes
        return out

    def _seg(self, device) -> torch.Tensor:
        return torch.arange(self.local.start, self.local.stop,
                            device=device)

    def all_gather_each(self, xs: list) -> torch.Tensor:
        """(local segs, nseg*rows, ...): every local segment's gathered
        buffer. After k hops segment i holds the block of segment
        (i−k) mod n and places it at that segment's global slot."""
        x = _stack(xs)
        n, rows = self.n, x.shape[1]
        seg = self._seg(x.device)
        loc = seg - self.local.start
        out = x.new_zeros((x.shape[0], n) + tuple(x.shape[1:]))
        cur = x
        for k in range(n):
            out[loc, (seg - k) % n] = cur
            if k + 1 < n:
                cur = self._shift(cur)
        return out.reshape((x.shape[0], n * rows) + tuple(x.shape[2:]))

    def all_gather(self, xs: list, unsigned: bool = False) -> torch.Tensor:
        return self.all_gather_each(xs)[0]

    def all_to_all(self, xs: list) -> list:
        # round k: each segment i sends its block for destination i+k a
        # distance of k; destination j receives source (j−k)'s block
        x = _stack(xs)                         # (src, dst, B, ...)
        n = self.n
        seg = self._seg(x.device)
        loc = seg - self.local.start
        out = torch.zeros_like(x)              # (dst, src, B, ...)
        nch = self.chunks if (x.ndim > 2
                               and x.shape[2] % self.chunks == 0) else 1
        bytes0 = self.dist_bytes
        for k in range(n):
            block = x[loc, (seg + k) % n]
            if k == 0:
                moved = block
            elif nch > 1:
                moved = torch.cat([self._shift(p, k)
                                   for p in block.chunk(nch, dim=1)], dim=1)
            else:
                moved = self._shift(block, k)
            out[loc, (seg - k) % n] = moved
        if self.P > 1:
            self.exchanges.append({"op": "all_to_all",
                                   "bytes": self.dist_bytes - bytes0})
        return list(out)

    def _ring_reduce(self, xs: list, op) -> torch.Tensor:
        acc = cur = _stack(xs)
        for _ in range(self.n - 1):
            cur = self._shift(cur)
            acc = op(acc, cur)
        if self.P == 1:
            return acc[0]
        # segment 0's accumulation (its order of the float adds), from
        # the process that owns it
        host, back = _wire_view(acc[0])
        if self.rank != self.owners[0]:
            host = torch.empty_like(host)
        else:
            self.dist_bytes += host.numel() * host.element_size() \
                * (self.P - 1)
        dist.broadcast(host, src=self.owners[0])
        return back(host)

    def psum(self, xs: list) -> torch.Tensor:
        return self._ring_reduce(xs, torch.add)

    def pmax(self, xs: list) -> torch.Tensor:
        return self._ring_reduce(xs, torch.maximum)


class HierarchicalCollectives:
    """Topology-aware two-level collectives over a uniform contiguous
    HostTopology (host h owns segments [h*S, (h+1)*S)): every exchange
    splits into intra-host permutations (rotations within a host's
    segment block) and inter-host permutations (rotations between hosts
    along a lane), the reference's ppermute compositions.

    - ``all_gather`` of an unsigned payload (``unsigned=True``: the packed
      wire, u64 keys): host-root tree — intra-host ring gather, a ring
      between the hosts' lane-0 segments only, intra-host broadcast by an
      exact zero-fill sum. Other payloads delegate to the flat ``inner``.
    - ``hier_all_to_all`` (hash redistribute): re-buckets rows by
      destination HOST between the hops and ships one host-pair block at
      the ``host_cap`` rung; two route words place every row at exactly
      the flat all_to_all's slot.
    - ``host_ring_exchange``: the inter-host ring of host-combined vectors
      (the runtime-filter digest fold).
    - ``psum`` / ``pmax`` / ``all_to_all`` delegate flat.

    ``launches`` counts the permutations, one per reference ppermute.

    Across processes (``inner`` a ``ProcessCollectives``) the stacked
    dimension holds this process's segments only: a permutation moves
    the pairs whose segments are both local by index and the others
    through one ``dist.all_to_all_single`` (skipped, on every process
    alike, when no pair crosses), so ``launches`` is the one-process
    count and a host that is a process keeps its intra-host hops local."""

    name = "hier"
    is_hierarchical = True

    def __init__(self, topo, inner=None):
        self.inner = inner if inner is not None else OneCardCollectives()
        self.hier_topo = topo
        self.n = topo.n_segments
        self.H = topo.n_hosts
        self.S = topo.n_segments // max(topo.n_hosts, 1)
        if not topo.uniform_contiguous() or self.H < 2:
            raise ValueError(
                "HierarchicalCollectives needs a uniform contiguous "
                f"multi-host topology; got {topo.as_dict()}")
        # the segment layout (every segment on process 0 in one
        # process): this process's segments [lo, lo + nl)
        self.owners = getattr(self.inner, "owners", (0,) * self.n)
        self.rank = getattr(self.inner, "rank", 0)
        self.local = getattr(self.inner, "local", range(self.n))
        self.P = getattr(self.inner, "P", 1)
        self.lo, self.nl = self.local.start, len(self.local)
        self.launches = 0
        # this transport's bytes to torch.distributed (its flat inner
        # exchange counts its own), and one list of redistributes with
        # the inner exchange's, in order
        self.dist_bytes = 0
        self.exchanges: list = getattr(self.inner, "exchanges", [])

    @property
    def total_dist_bytes(self) -> int:
        """This transport's and its flat inner exchange's bytes."""
        return self.dist_bytes + getattr(self.inner, "dist_bytes", 0)

    # ------------------------------------------------------ primitives

    def _table(self, key, device, build):
        k = (self.n, self.H, self.lo, self.nl, key, str(device))
        with _TABLES_LOCK:
            hit = _TABLES.get(k)
        if hit is None:
            hit = tuple(torch.as_tensor(a, device=device) for a in build())
            with _TABLES_LOCK:
                if len(_TABLES) >= _TABLES_MAX:
                    _TABLES.pop(next(iter(_TABLES)))
                _TABLES[k] = hit
        return hit

    def _ids(self, device):
        """(local index, host, lane, global segment) vectors of this
        process's segments (every segment in one process)."""
        S = self.S

        def build():
            loc = np.arange(self.nl, dtype=np.int64)
            seg = loc + self.lo
            return loc, seg // S, seg % S, seg
        return self._table("ids", device, build)

    def _pp(self, x: torch.Tensor, perm) -> torch.Tensor:
        """One permutation of the segment dimension (``_permute``):
        segment ``dst`` receives segment ``src``'s value for every
        (src, dst) pair; segments that receive nothing read zeros."""
        self.launches += 1
        out, nbytes = _permute(x, perm, self.owners, self.rank)
        self.dist_bytes += nbytes
        return out

    def _intra_shift(self, x, by: int = 1):
        """Rotate within each host's segment block."""
        H, S = self.H, self.S
        return self._pp(x, [(h * S + t, h * S + (t + by) % S)
                            for h in range(H) for t in range(S)])

    def _lane_shift(self, x, by: int = 1):
        """Rotate between hosts along every lane."""
        H, S = self.H, self.S
        return self._pp(x, [(h * S + t, ((h + by) % H) * S + t)
                            for h in range(H) for t in range(S)])

    # --------------------------------------------------- intra helpers

    def intra_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(nseg, rows, ...) -> (nseg, S*rows, ...): each segment gathers
        its HOST's blocks in local order (S−1 intra shifts)."""
        S = self.S
        if S == 1:
            return x
        loc, _, t, _ = self._ids(x.device)
        rows = x.shape[1]
        out = x.new_zeros((self.nl, S) + tuple(x.shape[1:]))
        cur = x
        for k in range(S):
            out[loc, (t - k) % S] = cur
            if k + 1 < S:
                cur = self._intra_shift(cur)
        return out.reshape((self.nl, S * rows) + tuple(x.shape[2:]))

    def _intra_psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over each host's segments, accumulated into ``x`` in place
        (the caller's private buffer) — exact for the zero-filled tree
        broadcast."""
        cur = x
        for _ in range(self.S - 1):
            cur = self._intra_shift(cur)
            x.add_(cur)
        return x

    def _intra_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(nseg, S, C, ...) per-local-destination blocks -> received,
        within each host (the ring all_to_all's rotations, host-local)."""
        S = self.S
        if S == 1:
            return x
        loc, _, t, _ = self._ids(x.device)
        out = torch.zeros_like(x)
        for k in range(S):
            block = x[loc, (t + k) % S]
            moved = block if k == 0 else self._intra_shift(block, by=k)
            out[loc, (t - k) % S] = moved
        return out

    # ------------------------------------------------------- interface

    def psum(self, xs: list) -> torch.Tensor:
        return self.inner.psum(xs)

    def pmax(self, xs: list) -> torch.Tensor:
        return self.inner.pmax(xs)

    def all_to_all(self, xs: list) -> list:
        """Flat exchange (motions without host stamps); the two-level
        one is ``hier_all_to_all``."""
        return self.inner.all_to_all(xs)

    def all_gather(self, xs: list, unsigned: bool = False) -> torch.Tensor:
        """Host-root tree gather for unsigned payloads, bit-identical to
        the flat gather; everything else delegates flat."""
        if self.S == 1 or not unsigned:
            return self.inner.all_gather(xs)
        return self.tree_all_gather(_stack(xs))[0]

    def tree_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(nseg, rows, ...) -> every segment's (nseg*rows, ...) gathered
        buffer through the tree: intra-host gather, a lane-0 ring between
        hosts, then the intra-host broadcast of lane 0's result."""
        loc, h, t, _ = self._ids(x.device)
        H, S = self.H, self.S
        hb = self.intra_all_gather(x)                 # (nseg, S*rows, ...)
        full = hb.new_zeros((self.nl, H) + tuple(hb.shape[1:]))
        cur = hb
        lane0 = [(g * S, ((g + 1) % H) * S) for g in range(H)]
        for k in range(H):
            full[loc, (h - k) % H] = cur
            if k + 1 < H:
                cur = self._pp(cur, lane0)            # lane 0 only
        del cur, hb
        full = full.reshape((self.nl, H * S * x.shape[1])
                            + tuple(x.shape[2:]))
        # only lane 0 assembled its host's buffer: the other lanes feed
        # zeros into the broadcast sum
        full[t != 0] = 0
        return self._intra_psum(full)

    def host_ring_exchange(self, x: torch.Tensor) -> torch.Tensor:
        """(nseg, D) per-segment HOST-COMBINED vectors -> (nseg, H, D):
        each segment's host vectors in host order, via the all-lane
        inter-host ring (H−1 shifts)."""
        loc, h, _, _ = self._ids(x.device)
        H = self.H
        out = x.new_zeros((self.nl, H) + tuple(x.shape[1:]))
        cur = x
        for k in range(H):
            out[loc, (h - k) % H] = cur
            if k + 1 < H:
                cur = self._lane_shift(cur)
        return out

    # --------------------------------------------- two-level a2a (hash)

    def _hop1_tables(self, B: int, device):
        """Hop 1's static lane permutation of the (n*B) route rows: dest
        host g rides lane g % S at host slot g // S, then dest-local
        segment, then rank; pad rows past the last host."""
        n, H, S = self.n, self.H, self.S

        def build():
            k_hosts = -(-H // S)
            C1 = two_level_lane_rows(n, H, B)
            gidx = np.zeros((S, C1), dtype=np.int64)
            padm = np.zeros((S, C1), dtype=bool)
            for lane in range(S):
                pos = 0
                for j in range(k_hosts):
                    g = lane + j * S
                    for s in range(S):
                        if g < H:
                            base = (g * S + s) * B
                            gidx[lane, pos:pos + B] = np.arange(base,
                                                                base + B)
                        else:
                            padm[lane, pos:pos + B] = True
                        pos += B
            return gidx, padm
        return self._table(("hop1", B), device, build)

    def _rebucket_each(self, rows, key, valid, n_buckets: int, cap: int):
        """Every segment's ``kernels.wire_rebucket`` in one call: segment
        i's keys offset by i*n_buckets keep the segments' buckets apart,
        and the stable sort keeps each segment's rows in position order."""
        from cloudberry_tpu_torch.exec import kernels as K

        n, R, Wd = rows.shape
        off = torch.arange(n, device=rows.device).view(n, 1) * n_buckets
        buf, counts = K.wire_rebucket(
            rows.reshape(n * R, Wd), (key.to(torch.int64) + off).reshape(-1),
            valid.reshape(-1), n * n_buckets, cap)
        return (buf.reshape(n, n_buckets, cap, Wd),
                counts.reshape(n, n_buckets))

    def hier_all_to_all(self, xs: list, host_cap: int):
        """Two-level hash redistribute over packed wire blocks.

        ``xs[s]``: (nseg, B, W) int32 per-destination-SEGMENT blocks of
        source s — the flat all_to_all's exact input (word 0 bit 0 = row
        validity). Returns ``(recv, host_demand)``: recv[d] (nseg, B, W)
        BIT-IDENTICAL to the flat exchange's, and host_demand (nseg, H)
        int32 — the rows each segment's host addressed to every
        destination host, reported by the lane that owns it (others 0).

        Hops: (1) an intra-host all_to_all routes rows to the lane that
        owns their destination host (a static permutation); the lane
        re-buckets its host's rows by destination host into host-pair
        blocks at the ``host_cap`` rung; (2) one inter-host exchange of
        those blocks (H−1 permutations); (3) an intra-host scatter to the
        destination segment, then slot placement by the route words.
        Hop-1/hop-3 capacities are the proven bound ceil(H/S)*S*B, so
        only the host rung needs an overflow check. Every value stays
        non-negative in int32 while nseg*B < 2^31 (the caller's guard)."""
        x = _stack(xs)
        n, H, S, nl = self.n, self.H, self.S, self.nl
        B, W = int(x.shape[2]), int(x.shape[3])
        bytes0 = self.dist_bytes
        # (each staging buffer is released once the next hop holds its
        # rows: on one card every segment's staging coexists)
        k_hosts = -(-H // S)                   # hosts per lane (ceil)
        dev = x.device
        loc, h, t, seg = self._ids(dev)
        i32 = torch.int32

        flat = x.reshape(nl, n * B, W)
        slot = torch.arange(n * B, device=dev, dtype=i32)
        destw = (slot // B).view(1, -1).expand(nl, -1)
        origw = seg.to(i32).view(nl, 1) * B + (slot % B).view(1, -1)
        rbuf = torch.cat([flat, destw[..., None], origw[..., None]],
                         dim=2)                # (n, n*B, W+2)
        del x, flat

        # hop 1: static lane permutation + intra-host all_to_all
        gidx, padm = self._hop1_tables(B, dev)
        y = rbuf[:, gidx]                      # (n, S, C1, W+2)
        del rbuf
        y.masked_fill_(padm[None, :, :, None], 0)
        zf = self._intra_all_to_all(y).reshape(nl, -1, W + 2)
        del y

        # host combine: re-bucket the host's rows by destination host
        valid = (zf[..., 0] & 1).to(torch.bool)
        j_slot = (zf[..., W] // S) // S        # dest host's lane slot
        buf2, counts_j = self._rebucket_each(zf, j_slot, valid, k_hosts,
                                             host_cap)
        del zf, valid, j_slot
        lane_hosts = t.view(nl, 1) + torch.arange(
            k_hosts, device=dev).view(1, -1) * S
        demand = torch.zeros((nl, H + 1), dtype=i32, device=dev)
        demand.scatter_(1, torch.where(lane_hosts < H, lane_hosts,
                                       torch.full_like(lane_hosts, H)),
                        counts_j)
        host_demand = demand[:, :H]

        # hop 2: ONE aggregated inter-host exchange (H−1 permutations,
        # each moving every host's combined block for offset d)
        def host_block(g):
            blk = buf2[loc, (g // S).clamp(0, k_hosts - 1)]
            return torch.where((g % S == t).view(nl, 1, 1), blk,
                               torch.zeros_like(blk))

        out_dcn = buf2.new_zeros((nl, H, host_cap, W + 2))
        out_dcn[loc, h] = host_block(h)
        for d in range(1, H):
            recv = self._pp(host_block((h + d) % H), [
                (hh * S + ((hh + d) % H) % S, ((hh + d) % H) * S + hh % S)
                for hh in range(H)])
            out_dcn[loc, (h - d) % H] = recv
        del buf2, recv

        # hop 3: intra-host scatter to the destination segment
        f3 = out_dcn.reshape(nl, H * host_cap, W + 2)
        valid3 = (f3[..., 0] & 1).to(torch.bool)
        C3 = two_level_lane_rows(n, H, B)      # proven bound, no check
        buf3, _ = self._rebucket_each(f3, f3[..., W] % S, valid3, S, C3)
        del out_dcn, f3, valid3
        ff = self._intra_all_to_all(buf3).reshape(nl, S * C3, W + 2)
        del buf3

        # final placement: the flat layout's exact slot (src*B + rank)
        validf = (ff[..., 0] & 1).to(torch.bool)
        slotf = torch.where(validf, ff[..., W + 1].to(torch.int64),
                            torch.full_like(ff[..., W + 1], n * B,
                                            dtype=torch.int64))
        out = ff.new_zeros((nl, n * B + 1, W))
        out.view(-1, W)[(slotf + loc.view(nl, 1) * (n * B + 1))
                        .reshape(-1)] = ff[..., :W].reshape(-1, W)
        if self.P > 1:
            self.exchanges.append({"op": "hier_all_to_all",
                                   "bytes": self.dist_bytes - bytes0})
        return list(out[:, :n * B].reshape(nl, n, B, W)), host_demand


def two_level_lane_rows(nseg: int, n_hosts: int,
                        bucket_cap: int) -> int:
    """Rows one hop-1/hop-3 lane buffer holds: the PROVEN bound
    ceil(H/S)·S·B (every per-segment-pair bucket is capped at B by the
    caller's rank discipline). The one place the lane algebra lives: the
    transport sizes its staging with it, obs/capacity itemizes it."""
    S = nseg // n_hosts
    return -(-n_hosts // S) * S * bucket_cap


def two_level_wire_model(nseg: int, n_hosts: int, bucket_cap: int,
                         host_bucket_cap: int, row_bytes: int) -> dict:
    """Analytic per-redistribute byte split for the TWO-LEVEL exchange:
    the inter-host hop carries one aggregated block per ordered host pair
    at the host rung; the hop-1/hop-3 lane staging (send + receive each)
    stays within hosts. Every row carries the two route words."""
    S = nseg // n_hosts
    rb2 = row_bytes + 8
    lane = two_level_lane_rows(nseg, n_hosts, bucket_cap)
    return {
        "dcn_bytes": n_hosts * (n_hosts - 1) * host_bucket_cap * rb2,
        "ici_bytes": 2 * nseg * (S - 1) * lane * rb2,
    }


def flat_wire_model(nseg: int, n_hosts: int, bucket_cap: int,
                    row_bytes: int, sizes=None) -> dict:
    """The FLAT all_to_all's byte split under the same host grouping:
    every cross-host (source, destination) block crosses hosts padded to
    the pair rung; same-host blocks stay within hosts. ``sizes``: each
    host's segment count where they differ (a ragged cluster, whose
    host h sends |h|·(nseg − |h|) blocks across); default uniform."""
    if sizes is None:
        sizes = [nseg // n_hosts] * n_hosts
    blk = bucket_cap * row_bytes
    return {
        "dcn_bytes": sum(c * (nseg - c) for c in sizes) * blk,
        "ici_bytes": sum(c * (c - 1) for c in sizes) * blk,
    }


def hier_topology(cfg, n_segments: int, device_ids=None,
                  n_slots: int | None = None):
    """The two-level selection gate: the HostTopology motion splits
    over, or None for flat. Flat when the feature is off, the transport
    is not the packed one-card exchange, the layout is one host (always,
    without a forced split), or the split does not fit the segments (a
    forced count that does not divide a degraded segment count).
    ``auto`` and ``on`` differ only in the distributor's per-motion size
    gate (``interconnect.hier_min_block_bytes``)."""
    ic = cfg.interconnect
    if getattr(ic, "hierarchical", "off") not in ("auto", "on"):
        return None
    if ic.backend != "xla" or not ic.packed_wire:
        return None
    from cloudberry_tpu_torch.parallel.mesh import host_topology

    try:
        topo = host_topology(n_segments, device_ids, n_slots)
    except Exception:
        return None     # stale/odd restriction: the layout check reports
    if topo.n_hosts < 2 or n_segments % topo.n_hosts != 0 \
            or not topo.uniform_contiguous():
        return None
    return topo


def make_transport(backend: str, n_segments: int, chunks: int = 1,
                   topo=None, device_ids=None, n_slots: int | None = None):
    """The transport for a run: ``topo`` (a HostTopology from
    ``hier_topology``) selects the two-level exchange; else
    ``interconnect.backend`` names the flat one (``"xla"``, ``"ring"``
    with ``chunks``). ``device_ids`` and ``n_slots``: the session's
    survivor restriction and slot pool, checked as the reference's
    segment mesh checks its devices (parallel/mesh.py
    ``check_segments``); across processes they place the segments on
    the processes (``segment_owners``)."""
    from cloudberry_tpu_torch.parallel.mesh import (check_segments,
                                                    process_count,
                                                    process_index,
                                                    segment_owners)

    check_segments(n_segments, device_ids, n_slots)
    owners = None
    if process_count() > 1:
        owners = segment_owners(n_segments, device_ids, n_slots)
        flat = ProcessCollectives(owners, process_index())
    else:
        flat = OneCardCollectives()
    if topo is not None:
        return HierarchicalCollectives(topo, inner=flat)
    if backend == "xla":
        return flat
    if backend == "ring":
        return RingCollectives(n_segments, chunks=chunks, owners=owners,
                               rank=process_index())
    raise ValueError(f"unknown interconnect backend {backend!r} "
                     "(known: xla, ring)")
