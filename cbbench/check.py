"""The comparison that decides ``correct``: an answer as the client got
it over the wire against the plain reference's ``Result``.

Exact columns (strings, integers, dates and DECIMAL, which the wire
carries as float64 of the int64 over 10**scale) must be equal; a float
column's values are held by their relative gap. Rows that tie on the
ORDER BY columns may come in any order, and a LIMIT may cut a tie
anywhere: within each tied run the answer's rows are matched to the
reference's, the run the LIMIT cuts to a subset of them.

``Gaps`` are the numbers compared, each against its limit (``LIMITS``):
``wrong_cells`` counts exact cells that differ and rows missing or extra,
``float_rel_gap`` is the largest relative gap of a float cell,
``failed`` the statements that raised, ``unanswered`` the statements with
no answer a minute past the window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# the limits each compared number is held to (PERF.md gives the readings
# they were set from)
LIMITS = {"wrong_cells": 0, "float_rel_gap": 2e-15, "failed": 0,
          "unanswered": 0}


@dataclass
class Gaps:
    wrong_cells: int = 0
    float_rel_gap: float = 0.0
    failed: int = 0
    unanswered: int = 0
    checked: int = 0

    def add(self, other: "Gaps") -> None:
        self.wrong_cells += other.wrong_cells
        self.float_rel_gap = max(self.float_rel_gap, other.float_rel_gap)
        self.failed += other.failed
        self.unanswered += other.unanswered
        self.checked += other.checked

    def numbers(self) -> dict:
        return {k: getattr(self, k) for k in LIMITS}

    def correct(self) -> bool:
        return all(v <= LIMITS[k] for k, v in self.numbers().items())


def _rel(a, b) -> float:
    if a is None or b is None:
        return 0.0 if a is b else math.inf
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _row_gap(got: list, ref: list, kinds: list[str]) -> tuple[int, float]:
    """(exact cells that differ, largest float relative gap)."""
    if len(got) != len(ref):
        return len(ref), 0.0
    wrong, gap = 0, 0.0
    for g, r, k in zip(got, ref, kinds):
        if k == "f":
            gap = max(gap, _rel(g, r))
        elif g != r:
            wrong += 1
    return wrong, gap


def _tie_key(row: list, order: list[int], kinds: list[str]):
    return tuple(float(f"{row[c]:.12g}") if kinds[c] == "f" and
                 isinstance(row[c], float) else row[c] for c in order)


def compare(ref, rows: list[list]) -> Gaps:
    """Gaps of one answer's rows against the reference ``Result``."""
    out = Gaps(checked=1)
    want = ref.rows if ref.limit is None else ref.rows[:ref.limit]
    n_want = len(want)
    if len(rows) != n_want:
        out.wrong_cells += abs(len(rows) - n_want) * max(len(ref.kinds), 1)
    # the reference's tied runs, in order
    runs: list[list[list]] = []
    last = object()
    for row in ref.rows:
        key = _tie_key(row, ref.order, ref.kinds) if ref.order else None
        if not ref.order or key != last:
            runs.append([])
            last = key
        runs[-1].append(row)
    pos = 0
    for run in runs:
        if pos >= len(rows):
            break
        take = min(len(run), len(rows) - pos)
        got = rows[pos:pos + take]
        pos += take
        free = list(run)
        for g in got:
            best, best_i = None, -1
            for i, r in enumerate(free):
                w, f = _row_gap(g, r, ref.kinds)
                if best is None or (w, f) < best:
                    best, best_i = (w, f), i
                    if w == 0 and f == 0.0:
                        break
            if best is None:
                out.wrong_cells += len(ref.kinds)
                continue
            out.wrong_cells += best[0]
            out.float_rel_gap = max(out.float_rel_gap, best[1])
            free.pop(best_i)
    return out
