"""What the plain references share: the tables as device tensors, exact
fixed-point arithmetic, joins by sorted lookup, grouping, and ORDER BY
with LIMIT.

The references are plain PyTorch over the benchmark's own generated
columns (``gen``'s encoded tables); they import nothing of the program.
DECIMAL values are int64 at their scale, as the configuration's
guarantee states (exact answers). ``DB(exact=False)`` computes the same
DECIMAL arithmetic in float64 instead: the benchmark's control, the
precision below the stated one, which the comparison must refuse.

A reference returns a ``Result``: every row of the answer in its ORDER BY
order (rows tied with the LIMIT's last row kept, so that any tie order
the program picks is accepted), each column's kind ("x" compared exactly,
"f" a float compared by its relative gap), the ORDER BY columns and the
LIMIT.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch

from cbbench.gen.common import EPOCH, days, iso


@dataclass
class Result:
    rows: list[list]
    kinds: list[str]
    order: list[int]
    limit: int | None


class Dec:
    """A DECIMAL column: int64 at ``scale`` (exact) or float64 values."""

    __slots__ = ("t", "s")

    def __init__(self, t: torch.Tensor, s: int):
        self.t, self.s = t, s

    @property
    def exact(self) -> bool:
        return not self.t.dtype.is_floating_point

    def _pair(self, o):
        if not isinstance(o, Dec):
            o = Dec(torch.full_like(self.t, o), 0)
        if not self.exact:
            return self.t, o.t, max(self.s, o.s)
        s = max(self.s, o.s)
        return self.t * 10 ** (s - self.s), o.t * 10 ** (s - o.s), s

    def __add__(self, o):
        a, b, s = self._pair(o)
        return Dec(a + b, s)

    def __sub__(self, o):
        a, b, s = self._pair(o)
        return Dec(a - b, s)

    def __rsub__(self, o):
        a, b, s = self._pair(o)
        return Dec(b - a, s)

    __radd__ = __add__

    def __mul__(self, o):
        if not isinstance(o, Dec):
            o = Dec(torch.full_like(self.t, o), 0)
        return Dec(self.t * o.t, self.s + o.s)

    def __getitem__(self, idx):
        return Dec(self.t[idx], self.s)

    def sum_by(self, inv: torch.Tensor, n: int) -> "Dec":
        out = torch.zeros(n, dtype=self.t.dtype, device=self.t.device)
        return Dec(out.index_add_(0, inv, self.t), self.s)

    def total(self) -> "Dec":
        return Dec(self.t.sum().reshape(1), self.s)

    def sort_key(self) -> torch.Tensor:
        return self.t

    def floats(self) -> np.ndarray:
        """The values as the wire carries them: float64 of the int64
        divided by 10**scale (exact), or the float64 values."""
        v = self.t.cpu().numpy()
        if self.exact:
            return v.astype(np.float64) / (10.0 ** self.s)
        return v.astype(np.float64)


class DB:
    """The generated tables (host ``HostTable``s) on ``device``."""

    def __init__(self, tables, device, exact: bool = True,
                 float_dtype=torch.float64):
        self.tables = tables
        self.device = torch.device(device)
        self.exact = exact
        self.float_dtype = float_dtype
        self._cols: dict[tuple[str, str], torch.Tensor] = {}

    def col(self, t: str, c: str) -> torch.Tensor:
        key = (t, c)
        if key not in self._cols:
            self._cols[key] = torch.from_numpy(
                self.tables[t].columns[c]).to(self.device)
        return self._cols[key]

    def scale(self, t: str, c: str) -> int:
        return next(s for n, _, s in self.tables[t].fields if n == c)

    def dec(self, t: str, c: str) -> Dec:
        v = self.col(t, c)
        s = self.scale(t, c)
        if self.exact:
            return Dec(v, s)
        return Dec(v.to(self.float_dtype) / 10.0 ** s, s)

    def strings(self, t: str, c: str) -> list[str]:
        return self.tables[t].dicts[c]

    def code(self, t: str, c: str, value: str) -> int:
        try:
            return self.strings(t, c).index(value)
        except ValueError:
            return -1

    def where(self, t: str, c: str, pred) -> torch.Tensor:
        """bool per row: ``pred`` of the row's string."""
        table = torch.tensor([bool(pred(v)) for v in self.strings(t, c)],
                             dtype=torch.bool, device=self.device)
        return table[self.col(t, c).long()]

    def text(self, t: str, c: str):
        return Str(self.col(t, c), self.strings(t, c))

    def free(self) -> None:
        self._cols.clear()


class Str:
    """A string column: codes and their dictionary."""

    __slots__ = ("codes", "values")

    def __init__(self, codes: torch.Tensor, values: list[str]):
        self.codes, self.values = codes, values

    def __getitem__(self, idx):
        return Str(self.codes[idx], self.values)

    def sort_key(self) -> torch.Tensor:
        rank = np.empty(len(self.values), dtype=np.int64)
        rank[np.argsort(np.asarray(self.values, dtype=object),
                        kind="stable")] = np.arange(len(self.values))
        return torch.from_numpy(rank).to(self.codes.device)[
            self.codes.long()]


class Date:
    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getitem__(self, idx):
        return Date(self.t[idx])

    def sort_key(self) -> torch.Tensor:
        return self.t.long()


def add_months(day: int, months: int) -> int:
    d = EPOCH + datetime.timedelta(days=int(day))
    m = d.month - 1 + months
    return (datetime.date(d.year + m // 12, m % 12 + 1, d.day) - EPOCH).days


def year_of(day_numbers: torch.Tensor) -> torch.Tensor:
    """Calendar year of each day number (a table over the range seen)."""
    lo = int(day_numbers.min()) if day_numbers.numel() else 0
    hi = int(day_numbers.max()) if day_numbers.numel() else 0
    years = [(EPOCH + datetime.timedelta(days=d)).year
             for d in range(lo, hi + 1)]
    table = torch.tensor(years, dtype=torch.int64, device=day_numbers.device)
    return table[day_numbers.long() - lo]


def index_of(build: torch.Tensor, probe: torch.Tensor):
    """(found, row) of each probe key in ``build``'s unique keys."""
    order = torch.argsort(build)
    keys = build[order]
    if keys.numel() == 0:
        return (torch.zeros_like(probe, dtype=torch.bool),
                torch.zeros_like(probe, dtype=torch.int64))
    pos = torch.searchsorted(keys, probe).clamp(max=keys.numel() - 1)
    return keys[pos] == probe, order[pos]


def group(*keys: torch.Tensor):
    """(first row of each group, each row's group, number of groups)."""
    stacked = torch.stack([k.long() for k in keys], dim=1)
    _, inv = torch.unique(stacked, dim=0, return_inverse=True)
    n = int(inv.max()) + 1 if inv.numel() else 0
    first = torch.full((n,), inv.numel(), dtype=torch.int64,
                       device=inv.device)
    first.scatter_reduce_(0, inv, torch.arange(inv.numel(),
                                               device=inv.device),
                          reduce="amin")
    return first, inv, n


def count_by(inv: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int64,
                       device=inv.device).index_add_(
        0, inv, torch.ones_like(inv))


def _key(col) -> torch.Tensor:
    if isinstance(col, torch.Tensor):
        return col
    return col.sort_key()


def _values(col, idx: torch.Tensor) -> list:
    if isinstance(col, Dec):
        return col[idx].floats().tolist()
    if isinstance(col, Str):
        return [col.values[c] for c in col.codes[idx].cpu().tolist()]
    if isinstance(col, Date):
        return [iso(d) for d in col.t[idx].cpu().tolist()]
    v = col[idx].cpu().numpy()
    return v.astype(np.float64).tolist() if v.dtype.kind == "f" \
        else v.astype(np.int64).tolist()


def finish(cols: list, order: list[tuple[int, bool]],
           limit: int | None = None) -> Result:
    """The answer's rows: ``cols`` (Dec, Str, Date or tensors) sorted by
    ``order`` ((column, descending) pairs) and cut at ``limit``, keeping
    rows tied with the last one."""
    n = int(_key(cols[0]).shape[0])
    dev = _key(cols[0]).device
    idx = torch.arange(n, device=dev)
    for c, desc in reversed(order):
        k = _key(cols[c])[idx]
        idx = idx[torch.sort(k, stable=True, descending=desc).indices]
    if limit is not None and n > limit:
        keep = limit
        last = [_key(cols[c])[idx[limit - 1]] for c, _ in order]
        while keep < n and all(bool(_key(cols[c])[idx[keep]] == v)
                               for (c, _), v in zip(order, last)):
            keep += 1
        idx = idx[:keep]
    columns = [_values(c, idx) for c in cols]
    kinds = ["f" if isinstance(c, torch.Tensor) and c.dtype.is_floating_point
             else "x" for c in cols]
    return Result([list(r) for r in zip(*columns)] if columns else [],
                  kinds, [c for c, _ in order], limit)


def end_of(start: str, years: int = 0, months: int = 0) -> int:
    return add_months(days(start), 12 * years + months)
