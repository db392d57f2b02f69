"""Distribution hashing — the cdbhash analog (host half).

The reference routes tuples to segments by hashing distribution-key columns
(``makeCdbHash`` src/backend/cdb/cdbhash.c:78) and maps hash → segment with
``jump_consistent_hash`` (cdbhash.c:55) so that elastic resize (gpexpand /
gpshrink) moves a minimal fraction of rows. The numpy functions place rows
at load time (``catalog.Table.shard_assignment``); the torch functions
route rows on the device (a redistribute motion, exec/dist_executor.py).
The two halves must agree bit for bit, or a row lands on another segment
than its join partners.

The torch half computes in int64 with wrap-around mod 2^64 (the port's
convention, exec/kernels.py): add and multiply wrap like the reference's
uint64 arithmetic, every right shift is masked (``>>`` on int64 is
arithmetic), floats hash by their bit pattern (-0.0 and NaN hash as
patterns, as in the reference), and the jump hash's ``2^31 / denom`` is a
float64 tensor division, as numpy's is (a Python scalar divided by a
tensor is a reciprocal multiplication in PyTorch).
"""

from __future__ import annotations

import numpy as np
import torch

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


def _i64(v: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= 1 << 63 else v


_C1_T = _i64(_C1)
_C2_T = _i64(_C2)
_JUMP_T = _i64(_JUMP)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """Vectorized 64-bit avalanche hash (device), int64 bits."""
    z = x.to(torch.int64)
    z = (z ^ _shr(z, 30)) * _C1_T
    z = (z ^ _shr(z, 27)) * _C2_T
    return z ^ _shr(z, 31)


def combine_hashes(hs: list[torch.Tensor]) -> torch.Tensor:
    """Order-sensitive multi-column hash combine."""
    acc = torch.zeros(hs[0].shape, dtype=torch.int64, device=hs[0].device)
    for h in hs:
        acc = splitmix64(acc ^ h.to(torch.int64))
    return acc


def hash_columns(cols: list[torch.Tensor]) -> torch.Tensor:
    """Hash one or more columns to u64 bits (int64) — equal to
    ``hash_columns_np``'s bits."""
    return combine_hashes([splitmix64(_col_bits(c)) for c in cols])


def _col_bits(c: torch.Tensor) -> torch.Tensor:
    if c.dtype == torch.float64:
        return c.contiguous().view(torch.int64)
    if c.dtype == torch.float32:
        return c.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if c.dtype == torch.bool:
        return c.to(torch.int64)
    return c.to(torch.int64)


def jump_consistent_hash(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Device-side jump consistent hash over u64 bits (int64) — MUST equal
    ``jump_consistent_hash_np`` so motion routing lands rows where
    load-time placement put their join partners. Loops while any row is
    active (expected O(ln n) rounds); each round reads one flag on the
    host."""
    k = keys.to(torch.int64)
    b = torch.full(k.shape, -1, dtype=torch.int64, device=k.device)
    j = torch.zeros(k.shape, dtype=torch.int64, device=k.device)
    num = torch.full((), float(1 << 31), dtype=torch.float64,
                     device=k.device)
    active = j < n_buckets
    while bool(active.any()):
        b = torch.where(active, j, b)
        k = torch.where(active, k * _JUMP_T + 1, k)
        denom = (_shr(k, 33) + 1).to(torch.float64)
        j = torch.where(active, ((b + 1) * (num / denom)).to(torch.int64), j)
        active = j < n_buckets
    return b.to(torch.int32)


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
