"""What the generators share: seeded streams on the device, dictionary
encoding on the device, and the encoded table form.

A generated table is a ``Table``: its fields as (name, base, scale) with
``base`` a physical type name ("int64", "int32", "decimal", "date",
"string"), one tensor per column in the encoded form (int64 keys and
DECIMAL cents, int32 day numbers and dictionary codes) and each string
column's dictionary in code order. Nothing here imports the program.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

import numpy as np
import torch

EPOCH = datetime.date(1970, 1, 1)


def days(iso: str) -> int:
    """Day number of an ISO date (days since 1970-01-01)."""
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def iso(day: int) -> str:
    return (EPOCH + datetime.timedelta(days=int(day))).isoformat()


@dataclass
class Table:
    fields: list[tuple[str, str, int]]
    columns: dict[str, torch.Tensor]
    dicts: dict[str, list[str]] = field(default_factory=dict)

    def to_host(self) -> "HostTable":
        return HostTable(self.fields,
                         {k: v.cpu().numpy() for k, v in self.columns.items()},
                         self.dicts)


@dataclass
class HostTable:
    fields: list[tuple[str, str, int]]
    columns: dict[str, np.ndarray]
    dicts: dict[str, list[str]]

    @property
    def rows(self) -> int:
        return len(next(iter(self.columns.values())))


class Streams:
    """One torch.Generator per named stream, each seeded from the run's
    seed and the stream's name, so a table's values do not depend on
    which other tables a cell asks for."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def __call__(self, name: str) -> torch.Generator:
        h = 1469598103934665603
        for ch in name.encode():
            h = ((h ^ ch) * 1099511628211) % (1 << 64)
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 0x9E3779B97F4A7C15 + h) % (1 << 63))
        return g


def randint(g: torch.Generator, lo: int, hi: int, n: int) -> torch.Tensor:
    """int64 draws in [lo, hi)."""
    return torch.randint(lo, hi, (n,), generator=g, device=g.device,
                         dtype=torch.int64)


def rand(g: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand((n,), generator=g, device=g.device,
                      dtype=torch.float64)


def words(g: torch.Generator, n: int, nwords: int, vocab: int) -> torch.Tensor:
    """A phrase of ``nwords`` words from a vocabulary of ``vocab``, as one
    int64 code in base ``vocab`` (first word most significant)."""
    code = torch.zeros((n,), dtype=torch.int64, device=g.device)
    for _ in range(nwords):
        code = code * vocab + randint(g, 0, vocab, n)
    return code


def phrase_values(codes: np.ndarray, nwords: int, vocab: list[str]) -> list[str]:
    v = len(vocab)
    w = np.asarray(vocab, dtype=object)
    codes = np.asarray(codes, dtype=np.int64)
    digits = []
    for _ in range(nwords):
        digits.append(codes % v)
        codes = codes // v
    out = w[digits[-1]]
    for d in reversed(digits[:-1]):
        out = out + " " + w[d]
    return list(out)


def encode(raw: torch.Tensor, values_of) -> tuple[torch.Tensor, list[str]]:
    """Dictionary-encode a column of int64 raw codes: the distinct codes,
    sorted, become the dictionary (``values_of`` maps them, as a numpy
    array, to their strings) and each row gets its index as int32."""
    uniq, inv = torch.unique(raw, sorted=True, return_inverse=True)
    return inv.to(torch.int32), values_of(uniq.cpu().numpy())


def encode_chars(chars: torch.Tensor) -> tuple[torch.Tensor, list[str]]:
    """Dictionary-encode a column of ASCII strings given as an (n, w)
    int64 tensor of character codes, 0 past each string's end: the
    strings are packed eight bytes to an int64, the distinct ones, in byte
    order, become the dictionary, and each row gets its index as int32."""
    n, w = chars.shape
    pad = -w % 8
    if pad:
        chars = torch.nn.functional.pad(chars, (0, pad))
    shifts = torch.arange(56, -1, -8, device=chars.device)
    packed = (chars.reshape(n, -1, 8) << shifts).sum(dim=2)
    uniq, inv = torch.unique(packed, dim=0, return_inverse=True)
    raw = np.ascontiguousarray(uniq.cpu().numpy().astype(">i8"))
    values = raw.view(f"S{raw.shape[1] * 8}").ravel().astype(str)
    return inv.to(torch.int32), values.tolist()


def v_string(g: torch.Generator, n: int, lo: int, hi: int,
             alphabet: str) -> torch.Tensor:
    """TPC-H's random V-string: per row a length uniform in [lo, hi] and
    characters uniform over ``alphabet``, as an (n, hi) tensor of
    character codes, 0 past each string's end."""
    table = torch.tensor([ord(c) for c in alphabet], dtype=torch.int64,
                         device=g.device)
    length = randint(g, lo, hi + 1, n)
    idx = torch.randint(0, len(alphabet), (n, hi), generator=g,
                        device=g.device, dtype=torch.int64)
    live = torch.arange(hi, device=g.device) < length[:, None]
    return torch.where(live, table[idx], 0)


def digits(v: torch.Tensor, width: int) -> torch.Tensor:
    """The ``width`` decimal digits of each value, as character codes."""
    p = 10 ** torch.arange(width - 1, -1, -1, device=v.device)
    return (v[:, None] // p) % 10 + ord("0")


def fixed(idx: torch.Tensor, values: list[str]) -> tuple[torch.Tensor, list[str]]:
    """A column over a fixed list of values: codes are the indices."""
    return idx.to(torch.int32), list(values)
