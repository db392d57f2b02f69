"""Distribution hashing — the cdbhash analog (host half).

The reference routes tuples to segments by hashing distribution-key columns
(``makeCdbHash`` src/backend/cdb/cdbhash.c:78) and maps hash → segment with
``jump_consistent_hash`` (cdbhash.c:55) so that elastic resize (gpexpand /
gpshrink) moves a minimal fraction of rows. These numpy functions place rows
at load time (``catalog.Table.shard_assignment``); the device-side routing
half waits for the distributed slice of the port.
"""

from __future__ import annotations

import numpy as np

# splitmix64 finalizer constants — a well-mixed 64-bit avalanche.
_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)
_JUMP = np.uint64(2862933555777941757)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * _C1
        z = (z ^ (z >> np.uint64(27))) * _C2
        return z ^ (z >> np.uint64(31))


def combine_hashes_np(hs: list[np.ndarray]) -> np.ndarray:
    acc = np.zeros_like(hs[0], dtype=np.uint64)
    for h in hs:
        acc = splitmix64_np(acc ^ h.astype(np.uint64))
    return acc


def hash_columns_np(cols: list[np.ndarray]) -> np.ndarray:
    return combine_hashes_np([splitmix64_np(_col_bits_np(c)) for c in cols])


def _col_bits_np(c: np.ndarray) -> np.ndarray:
    if c.dtype == np.float64:
        return c.view(np.uint64)
    if c.dtype == np.float32:
        return c.view(np.uint32).astype(np.uint64)
    if c.dtype == np.bool_:
        return c.astype(np.uint64)
    return c.astype(np.int64).view(np.uint64)


def jump_consistent_hash_np(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    """Lamping-Veach jump consistent hash, vectorized over keys (host side).

    Used for data placement so a resize from N to N+1 buckets relocates only
    ~1/(N+1) of rows (reference: cdbhash.c:55, gpexpand minimal movement).
    """
    keys = keys.astype(np.uint64)
    b = np.full(keys.shape, -1, dtype=np.int64)
    j = np.zeros(keys.shape, dtype=np.int64)
    active = j < n_buckets
    with np.errstate(over="ignore"):
        while active.any():
            b = np.where(active, j, b)
            keys = np.where(active, keys * _JUMP + np.uint64(1), keys)
            denom = ((keys >> np.uint64(33)) + np.uint64(1)).astype(np.float64)
            j = np.where(
                active,
                ((b + 1) * (float(1 << 31) / denom)).astype(np.int64),
                j,
            )
            active = j < n_buckets
    return b.astype(np.int32)
