"""Host-side string dictionaries.

Variable-length data never enters device tensors: string columns are int32
codes on device; the dictionary (code → str) lives on the host. String
predicates (LIKE, =, IN) are evaluated once over the dictionary on the host,
producing either a literal code (equality) or a boolean lookup table that the
device gathers by code — O(|dict|) host work, O(1) per row on device.
The reference's PAX engine uses the same idea (dictionary encodings,
contrib/pax_storage README "encodings"); classic Cloudberry instead pays
per-tuple varlena serialization in tupser.c, which has no TPU analog.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Callable, Iterable

import numpy as np


class StringDictionary:
    """Immutable-ish ordered dictionary: values[code] == string.

    Sorted insertion is NOT guaranteed; ordering comparisons on strings use
    a rank table (see ``rank_table``).
    """

    __slots__ = ("values", "_idx")

    def __init__(self, values: Iterable[str] = ()):
        self.values: list[str] = list(values)
        # value -> code, built at the first lookup: a copied or stored
        # dictionary (a comment column's holds a value per row) is often
        # only decoded and never asked for a code
        self._idx: dict[str, int] | None = None

    @property
    def _index(self) -> dict[str, int]:
        idx = self._idx
        if idx is None:
            idx = self._idx = {v: i for i, v in enumerate(self.values)}
        return idx

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, value: str) -> int:
        """Code for value, or -1 if absent (absent ⇒ no row can equal it)."""
        return self._index.get(value, -1)

    def add(self, value: str) -> int:
        code = self._index.get(value)
        if code is None:
            code = len(self.values)
            self.values.append(value)
            self._index[value] = code
        return code

    def encode(self, arr: Iterable[str]) -> np.ndarray:
        """Codes of ``arr``'s values, unseen values appended in the order
        they first appear (None included): the distinct values go through
        ``add`` once each, then one lookup per value gives its code."""
        if not isinstance(arr, (list, tuple, np.ndarray)):
            arr = list(arr)
        for v in dict.fromkeys(arr):
            self.add(v)
        return np.fromiter(map(self._index.__getitem__, arr),
                           dtype=np.int32, count=len(arr))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        vals = np.asarray(self.values, dtype=object)
        out = np.empty(codes.shape, dtype=object)
        valid = codes >= 0
        out[valid] = vals[codes[valid]]
        out[~valid] = None
        return out

    def predicate_table(self, pred: Callable[[str], bool]) -> np.ndarray:
        """bool[len(dict)] lookup table for an arbitrary string predicate."""
        return np.fromiter((bool(pred(v)) for v in self.values),
                           dtype=np.bool_, count=len(self.values))

    def like_table(self, pattern: str) -> np.ndarray:
        """SQL LIKE over the dictionary (% → .*, _ → .)."""
        rx = re.compile(_like_to_regex(pattern), re.DOTALL)
        return self.predicate_table(lambda v: rx.fullmatch(v) is not None)

    def rank_table(self) -> np.ndarray:
        """int32[len(dict)] such that rank[a] < rank[b] iff values[a] < values[b].

        Lets the device ORDER BY / compare string columns by gathering ranks.
        """
        order = np.argsort(np.asarray(self.values, dtype=object), kind="stable")
        ranks = np.empty(len(self.values), dtype=np.int32)
        ranks[order] = np.arange(len(self.values), dtype=np.int32)
        return ranks


def _like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)
