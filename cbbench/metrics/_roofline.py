"""The bytes that each CUDA kernel's launch has to move, and the least
time they take at the card's peak (``peaks.json``).

Frozen counting functions, one per kernel, taking the arguments of the
program's kernel entry point (``exec/cuda_kernels.py``). Each input byte
the launch needs is read once and each output byte written once. Where
the kernel's work depends on the data (rows that a selection keeps, rows
that lie in a group), only what these inputs need counts: sums over the
data run on the device, after the launch's own inputs are ready, and are
read after the window. The kernels do one add or compare per byte or
less, so the bytes bound them: operations are not counted.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


@dataclass
class Bytes:
    """Bytes of one launch: ``fixed`` plus a device scalar read later."""

    fixed: int
    extra: torch.Tensor | None = None

    def resolve(self) -> int:
        if self.extra is None:
            return self.fixed
        return self.fixed + int(self.extra)


def least_seconds(nbytes: int) -> float:
    return nbytes / PEAKS["hbm_bytes_per_s"]


def dense_agg_bytes(gid, ivals, fvals, sel, n_cells) -> Bytes:
    """Grouped COUNT and SUM over n_cells cells: sel is read for every
    row, gid (4 B) and the K value rows (8 B each) for kept rows; the
    (1 + K) x cells sums are written."""
    n, k = int(gid.shape[0]), int(ivals.shape[0]) + int(fvals.shape[0])
    kept = sel.sum()
    return Bytes(n + (1 + k) * int(n_cells) * 8, kept * (4 + 8 * k))


def sorted_seg_bytes(vals, starts, ends, n_groups, cap) -> Bytes:
    """Segmented SUM over group-sorted rows: the group count, the start
    and end of each of the n_groups groups and the R value rows of the
    rows inside them are read; (1 + R) x cap counts and sums are written
    (zero past n_groups)."""
    r = int(vals.shape[0])
    ng = n_groups.reshape(()).to(torch.int64)
    valid = torch.arange(int(cap), device=starts.device) < ng
    rows = torch.where(valid, ends - starts + 1, 0).sum()
    return Bytes(8 + (1 + r) * int(cap) * 8, ng * 16 + rows * 8 * r)


def probe_join_bytes(bkeys, bsel, pkeys, psel, payload, dup) -> Bytes:
    """Probe join against a build of B <= 2048 rows: the build's keys,
    selection and payload are read; each probe row's selection, and the
    keys of kept probe rows; the matched flags and the payload gathered
    to every probe row are written, and the duplicate flag."""
    b, n = int(bsel.shape[0]), int(psel.shape[0])
    bkey = sum(k.element_size() for k in bkeys)
    pkey = sum(k.element_size() for k in pkeys)
    pay = sum(c.element_size() for c in payload)
    kept = psel.sum()
    return Bytes(b * (1 + bkey + pay) + n * (2 + pay) + 4, kept * pkey)


def share(tracer, kernel: str):
    """The kernel's share of its roofline over the window's launches, in
    %: the least time of every launch's bytes over the kernel's device
    time in the profiler. None where the window has no launch or no
    device time of it (a CPU run has none)."""
    if tracer is None or not tracer.on_card or not tracer.device_ops:
        return None
    launches = tracer.launches[kernel]
    dev = tracer.kernel_seconds(kernel)
    if not launches or dev <= 0:
        return None
    return 100.0 * least_seconds(sum(launches)) / dev
