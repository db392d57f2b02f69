"""Relational kernels over fixed-capacity column batches, in PyTorch.

The port of the JAX package's exec/kernels.py. The same discipline holds:
- filters AND into the selection mask (no compaction);
- group-by is sort-based: lexsort → boundary flags → segment reductions;
- joins are "sorted-build lookup": sort the unique (PK) side, binary-search
  probes with ``searchsorted``, gather payloads.

Unsigned keys. The reference normalizes every key column to a sortable
uint64. PyTorch's unsigned types support little beyond storage, so a u64
key is carried here as int64 WITH THE SIGN BIT FLIPPED ("biased"): signed
order of the biased value equals unsigned order of the u64, and the bits
are the u64's bits XOR 2^63. Integer columns are their own biased key.
Spans and differences are raw u64 bits held in int64; int64 add/multiply
wrap mod 2^64 exactly as the reference's uint64 arithmetic does. Packed
32-bit keys are int32 with the sign bit flipped the same way.

These replace the reference's per-tuple executor nodes: nodeAgg.c,
nodeHash.c/nodeHashjoin.c, nodeSort.c, nodeLimit.c.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

Columns = dict[str, torch.Tensor]

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_I32_MAX = (1 << 31) - 1
# the reference's u64 all-ones sentinel, biased (sign bit flipped)
_U64_MAX_B = _I64_MAX
_U32_MAX_B = _I32_MAX


def _full(like: torch.Tensor, value, dtype=None) -> torch.Tensor:
    return torch.full((), value, dtype=dtype or like.dtype, device=like.device)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned less-than over raw u64 bits held in int64."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def sort_key_u64(col: torch.Tensor) -> torch.Tensor:
    """Map a column to a biased u64 key (int64) preserving SQL ascending
    order — the reference's sort_key_u64 with the sign bit flipped."""
    if col.dtype == torch.bool:
        return col.to(torch.int64) + _I64_MIN
    if col.dtype == torch.float32:
        bits = col.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        mask = torch.where((bits >> 31) != 0, _full(bits, 0xFFFFFFFF),
                           _full(bits, 0x80000000))
        return (bits ^ mask) + _I64_MIN
    if col.dtype == torch.float64:
        # IEEE total-order trick: negative values flip all bits, positive
        # ones the sign bit; biasing flips the sign bit once more
        bits = col.contiguous().view(torch.int64)
        return torch.where(bits < 0, bits ^ _I64_MAX, bits)
    return col.to(torch.int64)


def key_ranges(
    keys: Sequence[torch.Tensor], sel: torch.Tensor
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-column (lo, span) over the SELECTED rows: ``lo`` a biased key,
    ``span`` raw u64 bits (hi - lo + 1, wrapping)."""
    out = []
    for k in keys:
        s = sort_key_u64(k)
        lo = torch.where(sel, s, _full(s, _I64_MAX)).min()
        hi = torch.where(sel, s, _full(s, _I64_MIN)).max()
        out.append((lo, hi - lo + 1))
    return out


def pack_with_ranges(
    keys: Sequence[torch.Tensor],
    ranges: Sequence[tuple[torch.Tensor, torch.Tensor]],
) -> torch.Tensor:
    """Pack key columns into ONE order-preserving biased u64 (int64) using
    given ranges. Values outside a range pack to the all-ones sentinel,
    which never equals an in-range pack (the reference's contract)."""
    packed = torch.zeros(keys[0].shape, dtype=torch.int64,
                         device=keys[0].device)
    oob = torch.zeros(keys[0].shape, dtype=torch.bool, device=keys[0].device)
    for k, (lo, span) in zip(keys, ranges):
        s = sort_key_u64(k)
        d = s - lo                       # u - lo mod 2^64 (raw bits)
        oob = oob | (s < lo) | ~_ult(d, span)
        top = span - 1
        packed = packed * span + torch.where(_ult(d, top), d, top)
    return torch.where(oob, _full(packed, _U64_MAX_B), packed ^ _I64_MIN)


def pack_keys(keys: Sequence[torch.Tensor],
              sel: torch.Tensor) -> torch.Tensor:
    """Pack multiple key columns of one batch into an order-preserving
    biased u64 (selected rows are in-range by construction)."""
    return pack_with_ranges(keys, key_ranges(keys, sel))


def downcast32(packed: torch.Tensor) -> torch.Tensor:
    """Narrow biased u64 packs to biased u32 (int32) when the PLANNER proved
    every in-range pack fits 32 bits; the u64 sentinel maps to the u32
    sentinel."""
    low = ((packed ^ _I64_MIN) & 0xFFFFFFFF) - (1 << 31)
    return torch.where(packed == _U64_MAX_B, _full(low, _U32_MAX_B),
                       low).to(torch.int32)


def _stable_argsort(k: torch.Tensor) -> torch.Tensor:
    if k.dtype == torch.bool:
        k = k.to(torch.uint8)
    return torch.sort(k, stable=True).indices


def sort_indices(
    keys: Sequence[torch.Tensor],
    sel: torch.Tensor,
    descending: Sequence[bool] | None = None,
) -> torch.Tensor:
    """Permutation putting selected rows first, ordered by keys — the
    reference's ``jnp.lexsort``, as stable sorts from the least to the most
    significant key, so ties keep the reference's row order.

    keys[0] is the PRIMARY key (SQL ORDER BY first column)."""
    desc = list(descending) if descending is not None else [False] * len(keys)
    cols = []
    for k, d in zip(keys, desc):
        s = sort_key_u64(k)
        cols.append(~s if d else s)
    perm = torch.arange(sel.shape[0], device=sel.device)
    for k in list(reversed(cols)) + [~sel]:
        perm = perm[_stable_argsort(k[perm])]
    return perm


# --------------------------------------------------------------------------
# group-by
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AggSpec:
    """One aggregate: func ∈ {sum,count,min,max,avg}; count with arg=None is
    COUNT(*)."""
    func: str
    out_name: str


@dataclass
class GroupLayout:
    """Sorted-group scaffolding shared by the sort-based aggregation and
    the sorted-segment CUDA kernel — ONE implementation of the sort,
    boundary detection, and start compaction, so the two paths cannot
    diverge on a grouping rule."""

    names: list
    perm: torch.Tensor        # sort permutation (selected rows first)
    s_sel: torch.Tensor       # selection in sorted order
    s_keys: Columns           # key columns in sorted order
    new_grp: torch.Tensor     # group-start flags over sorted selected rows
    n_groups: torch.Tensor
    n_sel: torch.Tensor
    starts: torch.Tensor      # per output slot: group start row (0 pad)
    ends: torch.Tensor        # per output slot: group end row (0 pad)
    valid: torch.Tensor       # slot < n_groups
    out_keys: Columns         # compacted key columns (zeros on pad)


def group_layout(key_cols: Columns, sel: torch.Tensor,
                 out_capacity: int) -> GroupLayout:
    names = list(key_cols)
    key_list = [key_cols[n] for n in names]
    perm = sort_indices(key_list, sel)
    s_sel = sel[perm]
    s_keys = {n: key_cols[n][perm] for n in names}

    new_grp = torch.zeros_like(s_sel)
    for n in names:
        k = s_keys[n]
        new_grp = new_grp | (k != torch.roll(k, 1))
    new_grp[0] = True
    new_grp = new_grp & s_sel

    n_groups = new_grp.sum(dtype=torch.int64)
    n_sel = s_sel.sum(dtype=torch.int64)

    # boundary positions compact to the front via a stable bool argsort
    starts_all = _stable_argsort(~new_grp)
    g = torch.arange(out_capacity, device=sel.device)
    last = starts_all.shape[0] - 1
    starts = starts_all[g.clamp(0, last)]
    next_start = starts_all[(g + 1).clamp(0, last)]
    valid = g < n_groups
    ends = torch.where(g + 1 < n_groups, next_start - 1, n_sel - 1)
    zero = _full(starts, 0)
    starts = torch.where(valid, starts, zero)
    ends = torch.where(valid, ends, zero)

    out_keys: Columns = {}
    for n in names:
        k = s_keys[n]
        out_keys[n] = torch.where(valid, k[starts], _full(k, 0))
    return GroupLayout(names, perm, s_sel, s_keys, new_grp, n_groups,
                       n_sel, starts, ends, valid, out_keys)


def _is_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """int64 for integer-carried values (BIGINT, DECIMAL cents, INT32:
    widened so a numerator never wraps at 2^31), float64 otherwise."""
    return torch.int64 if _is_int(t) else torch.float64


def _masked(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.where(m, v, _full(v, 0))


def group_aggregate(
    key_cols: Columns,
    agg_values: dict[str, Optional[torch.Tensor]],
    aggs: Sequence[AggSpec],
    sel: torch.Tensor,
    out_capacity: int,
) -> tuple[Columns, Columns, torch.Tensor, torch.Tensor]:
    """Sort-based grouped aggregation (nodeAgg.c analog).

    Returns (out_key_cols, out_agg_cols, out_sel, n_groups); groups are
    emitted in ascending key order. ``n_groups`` is the TRUE group count —
    the executor checks it against out_capacity after the run. Every
    per-group aggregate is a cumulative-sum DIFFERENCE between consecutive
    group boundaries."""
    lay = group_layout(key_cols, sel, out_capacity)
    key_list = [key_cols[n] for n in lay.names]
    perm, s_sel = lay.perm, lay.s_sel
    starts, ends, valid = lay.starts, lay.ends, lay.valid

    def seg_sum(vals):
        # torch widens an integer cumsum to int64; the reference's keeps
        # the input dtype, so the difference narrows back (same bits)
        c0 = torch.cat([torch.zeros(1, dtype=vals.dtype,
                                    device=vals.device),
                        torch.cumsum(vals, 0)])
        return _masked(c0[ends + 1] - c0[starts], valid).to(vals.dtype)

    counts = _masked(ends - starts + 1, valid).to(torch.int64)

    extreme_perm_cache: dict[bool, torch.Tensor] = {}

    def seg_extreme(v_unpermuted, want_max: bool):
        # re-sort with the value as the last key: each group's extreme
        # lands on its boundary row
        if want_max not in extreme_perm_cache:
            extreme_perm_cache[want_max] = sort_indices(
                key_list + [v_unpermuted], sel,
                descending=[False] * len(key_list) + [want_max])
        return v_unpermuted[extreme_perm_cache[want_max]][starts]

    out_aggs: Columns = {}
    for spec in aggs:
        v = agg_values.get(spec.out_name)
        if spec.func == "count":
            out = counts
        elif spec.func == "count_nn":
            out = seg_sum((s_sel & v[perm]).to(torch.int64))
        elif spec.func == "sum":
            out = seg_sum(_masked(v[perm], s_sel))
        elif spec.func == "min":
            out = torch.where(valid & (counts > 0),
                              seg_extreme(v, want_max=False),
                              _dtype_max(v))
        elif spec.func == "max":
            out = torch.where(valid & (counts > 0),
                              seg_extreme(v, want_max=True),
                              _dtype_min(v))
        elif spec.func == "avg":
            masked = _masked(v[perm], s_sel).to(_acc_dtype(v))
            out = seg_sum(masked).to(torch.float64) / counts.clamp_min(1)
        else:
            raise NotImplementedError(spec.func)
        out_aggs[spec.out_name] = out

    out_sel = torch.arange(out_capacity, device=sel.device) < lay.n_groups
    return lay.out_keys, out_aggs, out_sel, lay.n_groups


def group_aggregate_dense(
    gid: torch.Tensor,
    n_cells: int,
    agg_values: dict[str, Optional[torch.Tensor]],
    aggs: Sequence[AggSpec],
    sel: torch.Tensor,
) -> tuple[Columns, torch.Tensor]:
    """Perfect-hash grouped aggregation for small, statically-known key
    domains (dictionary-coded strings: Q1's returnflag × linestatus), in
    the scatter formulation (the reference's strategy='segment'). Used
    where the dense-agg kernel's gate declines (min/max). Returns (agg
    columns indexed by cell id, occupancy mask)."""
    gid = torch.where(sel, gid.clamp(0, n_cells - 1),
                      _full(gid, n_cells)).to(torch.int64)
    dev = gid.device

    def seg(vv):
        out = torch.zeros(n_cells + 1, dtype=vv.dtype, device=dev)
        return out.index_add_(0, gid, vv)[:n_cells]

    def sext(vv, ident, reduce):
        out = torch.full((n_cells + 1,), ident, dtype=vv.dtype, device=dev)
        return out.scatter_reduce_(0, gid, vv, reduce)[:n_cells]

    counts = seg(sel.to(torch.int64))
    out: Columns = {}
    for spec in aggs:
        v = agg_values.get(spec.out_name)
        if spec.func == "count":
            out[spec.out_name] = counts
        elif spec.func == "count_nn":
            out[spec.out_name] = seg((sel & v).to(torch.int64))
        elif spec.func == "sum":
            out[spec.out_name] = seg(_masked(v, sel))
        elif spec.func == "min":
            big = _dtype_max(v)
            out[spec.out_name] = sext(torch.where(sel, v, big), big.item(),
                                      "amin")
        elif spec.func == "max":
            small = _dtype_min(v)
            out[spec.out_name] = sext(torch.where(sel, v, small),
                                      small.item(), "amax")
        elif spec.func == "avg":
            s = seg(_masked(v, sel).to(_acc_dtype(v)))
            out[spec.out_name] = s.to(torch.float64) / counts.clamp_min(1)
        else:
            raise NotImplementedError(spec.func)
    return out, counts > 0


def global_aggregate(
    agg_values: dict[str, Optional[torch.Tensor]],
    aggs: Sequence[AggSpec],
    sel: torch.Tensor,
) -> Columns:
    """Ungrouped aggregation → one-row columns (shape (1,))."""
    out: Columns = {}
    for spec in aggs:
        v = agg_values.get(spec.out_name)
        if spec.func == "count":
            r = sel.sum(dtype=torch.int64)
        elif spec.func == "count_nn":
            r = (sel & v).sum(dtype=torch.int64)
        elif spec.func == "sum":
            r = _masked(v, sel).sum()
        elif spec.func == "min":
            r = torch.where(sel, v, _dtype_max(v)).min()
        elif spec.func == "max":
            r = torch.where(sel, v, _dtype_min(v)).max()
        elif spec.func == "avg":
            s = _masked(v, sel).to(_acc_dtype(v)).sum().to(torch.float64)
            c = sel.sum(dtype=torch.int64)
            r = s / c.clamp_min(1)
        else:
            raise NotImplementedError(spec.func)
        out[spec.out_name] = r.reshape(1)
    return out


def _dtype_max(v: torch.Tensor) -> torch.Tensor:
    info = torch.finfo if v.dtype.is_floating_point else torch.iinfo
    return _full(v, info(v.dtype).max)


def _dtype_min(v: torch.Tensor) -> torch.Tensor:
    info = torch.finfo if v.dtype.is_floating_point else torch.iinfo
    return _full(v, info(v.dtype).min)


# --------------------------------------------------------------------------
# join: sorted-build lookup (PK–FK)
# --------------------------------------------------------------------------


def build_sort(
    build_key: Sequence[torch.Tensor],
    build_sel: torch.Tensor,
    bits: int = 64,
) -> tuple[torch.Tensor, torch.Tensor, list]:
    """The build side's sort scaffolding: (order, sorted packed keys,
    packing ranges), with the reference's stable tie order."""
    ranges = key_ranges(list(build_key), build_sel)
    kb = pack_with_ranges(list(build_key), ranges)
    big = _U64_MAX_B
    if bits == 32:
        kb, big = downcast32(kb), _U32_MAX_B
    kb_masked = torch.where(build_sel, kb, _full(kb, big))
    order = _stable_argsort(kb_masked)
    return order, kb_masked[order], ranges


def dup_check(kb_sorted: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """Duplicate build keys, off the already-sorted keys (the sentinel —
    unselected/out-of-range rows — never counts)."""
    big = _U32_MAX_B if bits == 32 else _U64_MAX_B
    if kb_sorted.shape[0] <= 1:
        return torch.zeros((), dtype=torch.bool, device=kb_sorted.device)
    return ((kb_sorted[1:] == kb_sorted[:-1])
            & (kb_sorted[1:] != big)).any()


def _probe_pack(probe_key, ranges, bits):
    kp = pack_with_ranges(list(probe_key), ranges)
    if bits == 32:
        return downcast32(kp), _U32_MAX_B
    return kp, _U64_MAX_B


def join_lookup_sorted(
    order: torch.Tensor,
    kb_sorted: torch.Tensor,
    ranges: Sequence[tuple[torch.Tensor, torch.Tensor]],
    probe_key: Sequence[torch.Tensor],
    probe_sel: torch.Tensor,
    bits: int = 64,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """join_lookup against a PRE-SORTED build: probe packing + binary
    search only."""
    kp, big = _probe_pack(probe_key, ranges, bits)
    pos = torch.searchsorted(kb_sorted, kp)
    pos_c = pos.clamp(0, kb_sorted.shape[0] - 1)
    # kp == sentinel marks out-of-range probes; excluding it also makes the
    # empty-build case (kb_sorted all sentinel) correctly match nothing.
    matched = (kb_sorted[pos_c] == kp) & probe_sel & (kp != big)
    build_row = order[pos_c].to(torch.int32)
    return build_row, matched, dup_check(kb_sorted, bits)


def join_lookup(
    build_key: Sequence[torch.Tensor],
    build_sel: torch.Tensor,
    probe_key: Sequence[torch.Tensor],
    probe_sel: torch.Tensor,
    bits: int = 64,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each probe row: index of the matching build row, a match mask,
    and whether the build side holds duplicate keys. Requires the build
    side unique on the key (the planner puts the PK side here)."""
    order, kb_sorted, ranges = build_sort(build_key, build_sel, bits)
    return join_lookup_sorted(order, kb_sorted, ranges, probe_key,
                              probe_sel, bits)


def gather_payload(cols: Columns, idx: torch.Tensor,
                   matched: torch.Tensor) -> Columns:
    """Gather build-side payload columns to probe rows (0 where
    unmatched)."""
    idx = idx.to(torch.int64)
    return {name: _masked(c[idx], matched) for name, c in cols.items()}


def join_expand(
    build_key: Sequence[torch.Tensor],
    build_sel: torch.Tensor,
    probe_key: Sequence[torch.Tensor],
    probe_sel: torch.Tensor,
    out_capacity: int,
    bits: int = 64,
):
    """Many-to-many join: emit ONE OUTPUT ROW PER MATCH PAIR.

    Returns (probe_row[out_cap], build_row[out_cap], out_sel[out_cap],
    matched[probe_cap], total_matches scalar)."""
    order, kb_sorted, ranges = build_sort(build_key, build_sel, bits)
    return join_expand_sorted(order, kb_sorted, ranges, probe_key,
                              probe_sel, out_capacity, bits)


def join_expand_sorted(
    order: torch.Tensor,
    kb_sorted: torch.Tensor,
    ranges: Sequence[tuple[torch.Tensor, torch.Tensor]],
    probe_key: Sequence[torch.Tensor],
    probe_sel: torch.Tensor,
    out_capacity: int,
    bits: int = 64,
):
    """join_expand against a PRE-SORTED build."""
    kp, big = _probe_pack(probe_key, ranges, bits)
    start = torch.searchsorted(kb_sorted, kp, right=False)
    end = torch.searchsorted(kb_sorted, kp, right=True)
    ok = probe_sel & (kp != big)
    cnt = _masked(end - start, ok).to(torch.int64)
    matched = cnt > 0

    offsets = torch.cumsum(cnt, 0)
    dev = probe_sel.device
    total = offsets[-1] if cnt.shape[0] else \
        torch.zeros((), dtype=torch.int64, device=dev)
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    # probe row for output slot j: first i with offsets[i] > j
    pi = torch.searchsorted(offsets, j, right=True)
    pi_c = pi.clamp(0, cnt.shape[0] - 1)
    base = offsets[pi_c] - cnt[pi_c]          # first slot of probe row pi
    k = j - base
    out_sel = j < total
    build_pos = (start[pi_c].to(torch.int64) + k).clamp(
        0, kb_sorted.shape[0] - 1)
    build_row = order[build_pos].to(torch.int32)
    return pi_c.to(torch.int32), build_row, out_sel, matched, total


# --------------------------------------------------------------------------
# bloom digest — runtime join filters (plan/nodes.py PRuntimeFilter
# mode="digest"): a fixed-size bitmap over RANGE-FREE key hashes, so every
# segment's insertions agree on bit positions without a range reduction
# first. The digest (per-key u64 min/max + the bitmap words) rides ONE
# small exchange; probe rows failing the min/max or bloom test drop BEFORE
# their redistribute. False positives only let extra rows through.
#
# u64 values are raw bits held in int64 here (not biased: ``bloom_hash``
# takes ``sort_key_u64(k) ^ _I64_MIN``), and the reference's u32 words are
# int32 words with the same bits (bit 31 is the sign bit).
# --------------------------------------------------------------------------


_MIX_M1 = -4658895280553007687   # 0xBF58476D1CE4E5B9 as int64
_MIX_M2 = -7723592293110705685   # 0x94D049BB133111EB
_MIX_SEED = -7046029254386353131  # 0x9E3779B97F4A7C15


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over u64 bits (int64, wrapping)."""
    x = (x ^ _shr(x, 30)) * _MIX_M1
    x = (x ^ _shr(x, 27)) * _MIX_M2
    return x ^ _shr(x, 31)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values as int32 (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def bloom_hash(key_u64s: Sequence[torch.Tensor]) -> torch.Tensor:
    """One u64 hash per row over the raw u64 key forms of the key tuple —
    independent of packing ranges, so equal key tuples hash identically
    on every segment."""
    h = torch.full(key_u64s[0].shape, _MIX_SEED, dtype=torch.int64,
                   device=key_u64s[0].device)
    for u in key_u64s:
        h = _mix64(h ^ u)
    return h


def bloom_bits_pow2(bits: int) -> int:
    """Clamp a configured bitmap size to a power of two >= 64."""
    return 1 << max(6, int(bits - 1).bit_length())


def _bloom_positions(h: torch.Tensor, bits: int, k: int) -> list:
    """k bit positions per row sliced from ONE 64-bit hash."""
    lb = max(bits.bit_length() - 1, 1)
    step = max((64 - lb) // max(k, 1), 1)
    return [(_shr(h, i * step) if i * step else h) & (bits - 1)
            for i in range(max(k, 1))]


def bloom_build(key_u64s: Sequence[torch.Tensor], sel: torch.Tensor,
                bits: int, k: int) -> torch.Tensor:
    """(bits // 32,) int32 bitmap words over the SELECTED rows' key
    hashes: a bool bitmap with one dump slot (the reference's
    ``mode="drop"`` scatter), packed to words; segments combine by OR."""
    h = bloom_hash(key_u64s)
    bm = torch.zeros((bits + 1,), dtype=torch.bool, device=h.device)
    for pos in _bloom_positions(h, bits, k):
        bm[torch.where(sel, pos, _full(pos, bits))] = True
    w = bm[:bits].reshape(bits // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=h.device)
    return _to_i32((w << shifts).sum(1))


def bloom_test(words: torch.Tensor, key_u64s: Sequence[torch.Tensor],
               bits: int, k: int) -> torch.Tensor:
    """Per-row membership test against packed bitmap words: True =
    possibly present, False = definitely absent."""
    h = bloom_hash(key_u64s)
    ok = torch.ones(h.shape, dtype=torch.bool, device=h.device)
    for pos in _bloom_positions(h, bits, k):
        w = words[pos >> 5]
        ok = ok & (((w >> (pos & 31).to(torch.int32)) & 1) != 0)
    return ok


# --------------------------------------------------------------------------
# motion wire format: every column of a row set (plus the row-validity
# mask) packed into ONE (rows, W) buffer of 32-bit words, so each motion
# moves one buffer instead of one per column. The reference's uint32 words
# are int32 here (same bits). 4-byte dtypes view as one word, 8-byte dtypes
# as two (lo, hi) — the little-endian ``view`` equals
# ``bitcast_convert_type``'s word order — and bool columns ride as bits of
# the leading flag word(s) next to the validity bit.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WireLayout:
    """Static description of one packed wire buffer. Word 0 bit 0 is the
    row-validity bit; bool columns occupy the following bits (spilling
    into additional flag words past 32 bools); wider columns get 1 or 2
    whole words each, in sorted-name order."""

    names: tuple          # all column names, layout order (bools first)
    dtypes: tuple         # torch dtype per name
    flag_bits: dict       # bool column name -> (word, bit)
    offsets: dict         # non-bool column name -> first word index
    n_flag_words: int     # leading words carrying validity + bool bits
    width: int            # W: total 32-bit words per row

    def row_bytes(self) -> int:
        return 4 * self.width

    def payload_bytes(self) -> int:
        """Bytes of actual column data per row (excludes flag-word
        padding)."""
        bits = 1  # validity
        total = 0
        for dt in self.dtypes:
            if _itemsize(dt) == 0:
                bits += 1
            else:
                total += _itemsize(dt)
        return total + (bits + 7) // 8


# the packed wire's dtype contract: bool columns (flag bits) and columns of
# exactly these byte widths
WIRE_ITEMSIZES = (4, 8)


def _itemsize(dt) -> int:
    """Bytes of a torch or numpy dtype; 0 for bool (a flag bit)."""
    if dt == torch.bool or (not isinstance(dt, torch.dtype)
                            and np.dtype(dt) == np.bool_):
        return 0
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).element_size()
    return np.dtype(dt).itemsize


def wire_layout(col_dtypes: dict) -> WireLayout:
    """Layout for a column dict (name -> dtype). Deterministic: bools in
    sorted order take flag bits, then the remaining columns in sorted
    order take whole words."""
    bools = sorted(n for n, dt in col_dtypes.items() if _itemsize(dt) == 0)
    wides = sorted(n for n, dt in col_dtypes.items() if _itemsize(dt) != 0)
    n_flag_words = max(1, -(-(1 + len(bools)) // 32))
    flag_bits = {}
    for i, n in enumerate(bools):
        flag_bits[n] = ((1 + i) // 32, (1 + i) % 32)
    offsets = {}
    w = n_flag_words
    for n in wides:
        size = _itemsize(col_dtypes[n])
        if size not in WIRE_ITEMSIZES:
            raise NotImplementedError(
                f"wire pack: column {n!r} has {size}-byte dtype "
                f"{col_dtypes[n]}; only 4/8-byte dtypes and bool ship")
        offsets[n] = w
        w += size // 4
    names = tuple(bools + wides)
    dtypes = tuple(col_dtypes[n] for n in names)
    return WireLayout(names, dtypes, flag_bits, offsets, n_flag_words, w)


def pack_wire(cols: Columns, sel: torch.Tensor,
              layout: WireLayout) -> torch.Tensor:
    """(rows, W) int32 buffer carrying every column and the validity
    mask. An all-zero row unpacks as invalid."""
    rows = sel.shape[0]
    words: list = [None] * layout.width
    flags = [torch.zeros((rows,), dtype=torch.int32, device=sel.device)
             for _ in range(layout.n_flag_words)]
    flags[0] = sel.to(torch.int32)
    for name, (w, bit) in layout.flag_bits.items():
        flags[w] = flags[w] | (cols[name].to(torch.int32) << bit)
    for i, f in enumerate(flags):
        words[i] = f
    for name, off in layout.offsets.items():
        c = cols[name].contiguous()
        if c.element_size() == 4:
            words[off] = c.view(torch.int32)
        else:
            u = c.view(torch.int32).reshape(rows, 2)
            words[off] = u[:, 0]
            words[off + 1] = u[:, 1]
    return torch.stack(words, dim=-1)


def unpack_wire(buf: torch.Tensor,
                layout: WireLayout) -> tuple[Columns, torch.Tensor]:
    """Inverse of pack_wire: bit-identical columns + the validity mask."""
    sel = (buf[:, 0] & 1).to(torch.bool)
    cols: Columns = {}
    for name, dt in zip(layout.names, layout.dtypes):
        if _itemsize(dt) == 0:
            w, bit = layout.flag_bits[name]
            cols[name] = ((buf[:, w] >> bit) & 1).to(torch.bool)
            continue
        off = layout.offsets[name]
        if _itemsize(dt) == 4:
            cols[name] = buf[:, off].contiguous().view(dt)
        else:
            pair = buf[:, off:off + 2].contiguous()
            cols[name] = pair.view(dt).reshape(-1)
    return cols, sel


def bucket_slots(key: torch.Tensor, valid: torch.Tensor, n_buckets: int,
                 cap: int):
    """The redistribute's slot assignment: a STABLE sort of the bucket
    ids (invalid rows go to bucket ``n_buckets``), each row's rank inside
    its bucket, and its flat slot ``bucket * cap + rank`` — the dump slot
    ``n_buckets * cap`` for invalid rows and rows past ``cap``. Returns
    (order, slot, valid-in-slot, per-bucket demand)."""
    n = key.shape[0]
    k = torch.where(valid, key.to(torch.int64),
                    _full(key, n_buckets, torch.int64))
    counts = torch.bincount(k, minlength=n_buckets + 1)[:n_buckets]
    order = torch.sort(k, stable=True).indices
    sorted_k = k[order]
    start = torch.searchsorted(
        sorted_k, torch.arange(n_buckets, dtype=torch.int64,
                               device=k.device))
    rank = torch.arange(n, device=k.device) - start[
        sorted_k.clamp(0, n_buckets - 1)]
    ok = (sorted_k < n_buckets) & (rank < cap)
    slot = torch.where(ok, sorted_k * cap + rank,
                       _full(sorted_k, n_buckets * cap))
    return order, slot, ok, counts


def scatter_slots(vals: torch.Tensor, slot: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """``zeros(n_slots).at[slot].set(vals, mode="drop")``: a scatter into
    one extra dump row, sliced off. Slots are distinct but the dump."""
    out = torch.zeros((n_slots + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    out[slot] = vals
    return out[:n_slots]


def wire_rebucket(rows: torch.Tensor, key: torch.Tensor,
                  valid: torch.Tensor, n_buckets: int,
                  cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Permutation re-bucket of PACKED wire rows (no unpack). Valid rows
    compact stably into their bucket's slots; all-zero fill pads the
    rest. Returns ((n_buckets, cap, W) buffer, (n_buckets,) demand) —
    rows past ``cap`` are dropped from the buffer but counted, so the
    caller's overflow check fires before any result could ship."""
    order, slot, _, counts = bucket_slots(key, valid, n_buckets, cap)
    out = scatter_slots(rows[order], slot, n_buckets * cap)
    return out.reshape(n_buckets, cap, rows.shape[1]), \
        counts.to(torch.int32)


def rung_up(n: int) -> int:
    """Round a bucket capacity up to its ladder rung (the next power of
    two, floor 8)."""
    n = max(int(n), 8)
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------


def limit_mask(sel: torch.Tensor, k: int, offset: int = 0) -> torch.Tensor:
    """Keep rows offset..offset+k of the SELECTED sequence (post-sort)."""
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    return sel & (rank >= offset) & (rank < offset + k)


def compact(
    cols: Columns, sel: torch.Tensor, capacity: int
) -> tuple[Columns, torch.Tensor, torch.Tensor]:
    """Stable-compact selected rows to the front at a (possibly smaller)
    capacity. Also returns the TRUE selected-row count; rows beyond
    capacity are truncated, which the caller must surface."""
    n_selected = sel.sum(dtype=torch.int64)
    idx = sort_indices([torch.zeros_like(sel, dtype=torch.int32)], sel)
    idx = idx[:capacity]
    out = {n: c[idx] for n, c in cols.items()}
    return out, sel[idx], n_selected
