"""Z-order (Morton) keys for write clustering.

The reference's PAX storage clusters files by z-order so per-file min/max
statistics become tight multi-column bounding boxes
(contrib/pax_storage/src/cpp/clustering/zorder_clustering.cc); same idea
here: CLUSTER <t> BY (a, b) reorders the table by the interleaved-bit key
below before the snapshot writer chunks rows into micro-partition files —
each file then covers a small rectangle of (a, b) space and manifest
min/max pruning skips most files for predicates on ANY clustered column.

Values are rank-normalized first (position in the column's sorted order,
scaled to the bit budget): z-order quality depends on dimensions having
comparable scales, and ranks are distribution-free — the same reason the
reference normalizes through its encoder rather than interleaving raw
bits. Host-side numpy by design: clustering is a write-path rewrite, not
a query-path op."""

from __future__ import annotations

import numpy as np

_TOTAL_BITS = 62  # stay inside int64


def zorder_key(columns: list[np.ndarray]) -> np.ndarray:
    """Morton key per row from k numeric columns (k >= 1)."""
    k = len(columns)
    if k == 0:
        raise ValueError("z-order needs at least one column")
    n = len(columns[0])
    bits = _TOTAL_BITS // k
    out = np.zeros(n, dtype=np.uint64)
    ranks = []
    for arr in columns:
        # rank-normalize to [0, 2^bits): argsort-of-argsort is the dense
        # row rank; ties keep input order, which is fine for locality
        order = np.argsort(arr, kind="stable")
        r = np.empty(n, dtype=np.int64)
        r[order] = np.arange(n, dtype=np.int64)
        if n > 1:
            r = (r * ((1 << bits) - 1)) // (n - 1)
        ranks.append(r.astype(np.uint64))
    for b in range(bits):
        for j, r in enumerate(ranks):
            out |= ((r >> np.uint64(b)) & np.uint64(1)) \
                << np.uint64(b * k + j)
    return out
