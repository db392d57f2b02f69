"""Logical type system and schemas.

Maps SQL types onto TPU-friendly physical dtypes. Strings are
dictionary-encoded at ingest (int32 codes + host-side dictionary) — the
reference reaches the same conclusion in its PAX columnar engine
(contrib/pax_storage: dictionary encodings + Arrow vectorized reader); on TPU
it is mandatory because variable-length data cannot live in device tensors.
Dates are int32 days since the Unix epoch. DECIMAL is carried as float64
logically, with exact int64 fixed-point accumulation for SUM (see
exec/kernels.py) — the reference uses PG numeric (arbitrary precision);
TPC-H money columns fit comfortably in the fixed-point scheme.
"""

from __future__ import annotations

import datetime
import enum
from dataclasses import dataclass

import numpy as np


class DType(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT64 = "float64"   # SQL DOUBLE
    DECIMAL = "decimal"   # int64 fixed-point, scale tracked in SqlType
    DATE = "date"         # int32 days since 1970-01-01
    STRING = "string"     # int32 dictionary codes

    @property
    def np_dtype(self) -> np.dtype:
        return {
            DType.BOOL: np.dtype(np.bool_),
            DType.INT32: np.dtype(np.int32),
            DType.INT64: np.dtype(np.int64),
            DType.FLOAT64: np.dtype(np.float64),
            DType.DECIMAL: np.dtype(np.int64),
            DType.DATE: np.dtype(np.int32),
            DType.STRING: np.dtype(np.int32),
        }[self]

    @property
    def is_numeric(self) -> bool:
        return self in (DType.INT32, DType.INT64, DType.FLOAT64, DType.DECIMAL)


@dataclass(frozen=True)
class SqlType:
    """Logical type + decimal scale.

    DECIMAL is carried as int64 scaled by 10**scale — deliberate TPU-first
    design: f64 is emulated (and f64 bitcasts unsupported) on TPU, while
    int64 adds/compares are cheap 2×int32 ops. Money arithmetic is exact and
    SUM() accumulates without float error (the reference uses PG arbitrary-
    precision numerics; fixed-point covers the same analytic workloads).
    """

    base: DType
    scale: int = 0

    def __post_init__(self):
        if self.base != DType.DECIMAL and self.scale != 0:
            raise ValueError("scale only valid for DECIMAL")

    @property
    def np_dtype(self) -> np.dtype:
        return self.base.np_dtype

    @property
    def is_numeric(self) -> bool:
        return self.base.is_numeric

    def __repr__(self):
        if self.base == DType.DECIMAL:
            return f"decimal({self.scale})"
        return self.base.value


BOOL = SqlType(DType.BOOL)
INT32 = SqlType(DType.INT32)
INT64 = SqlType(DType.INT64)
FLOAT64 = SqlType(DType.FLOAT64)
DATE = SqlType(DType.DATE)
STRING = SqlType(DType.STRING)


def DECIMAL(scale: int = 2) -> SqlType:
    return SqlType(DType.DECIMAL, scale)


@dataclass(frozen=True)
class Field:
    name: str
    type: SqlType
    # SQL default: columns are nullable unless declared NOT NULL
    nullable: bool = True

    @property
    def dtype(self) -> DType:
        return self.type.base


@dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in schema: {names}")

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    @staticmethod
    def of(**cols: "SqlType | DType") -> "Schema":
        fields = []
        for n, t in cols.items():
            if isinstance(t, DType):
                t = SqlType(t)
            fields.append(Field(n, t))
        return Schema(tuple(fields))


EPOCH = datetime.date(1970, 1, 1)


def date_to_days(d: datetime.date | str) -> int:
    if isinstance(d, str):
        d = datetime.date.fromisoformat(d)
    return (d - EPOCH).days


def days_to_date(days: int) -> datetime.date:
    return EPOCH + datetime.timedelta(days=int(days))


# SQL type-name → SqlType (parser uses this for CREATE TABLE; DECIMAL(p,s)
# gets its scale from the parser).
SQL_TYPE_MAP = {
    "boolean": BOOL,
    "bool": BOOL,
    "int": INT64,
    "integer": INT32,
    "int4": INT32,
    "bigint": INT64,
    "int8": INT64,
    "smallint": INT32,
    "double": FLOAT64,
    "float8": FLOAT64,
    "real": FLOAT64,
    "decimal": DECIMAL(2),
    "numeric": DECIMAL(2),
    "date": DATE,
    "text": STRING,
    "varchar": STRING,
    "char": STRING,
    "bpchar": STRING,
}
