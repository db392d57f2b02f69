"""ColumnBatch — the Arrow-layout unit of execution.

The reference executor pulls one tuple at a time through ExecProcNode
(src/backend/executor/execProcnode.c) and serializes tuples for motion
(tupser.c). Here the unit is a fixed-capacity batch of columns — each column
a 1-D device array — plus a boolean selection mask ``sel``. Filters AND into
``sel`` instead of compacting (XLA static shapes); kernels that must compact
(sort, join build) do so with masked keys. This is the "vectorization is the
default, not an add-on" stance from SURVEY.md §2.8 item 13.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from cloudberry_tpu_torch import types
from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
from cloudberry_tpu_torch.types import DType, Field, Schema, date_to_days


@dataclass
class ColumnBatch:
    """Host-facing container; executors work on the raw ``columns``/``sel``.

    ``validity``: per-column bool arrays for nullable (outer-join) columns —
    False rows render as NULL."""

    schema: Schema
    columns: dict[str, Any]          # name -> (capacity,) array (np or jax)
    sel: Any                         # (capacity,) bool array
    dicts: dict[str, StringDictionary] = field(default_factory=dict)
    validity: dict[str, Any] = field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return int(self.sel.shape[0])

    def num_rows(self) -> int:
        return int(np.asarray(self.sel).sum())

    @staticmethod
    def from_arrays(
        data: Mapping[str, np.ndarray],
        schema: Schema,
        dicts: dict[str, StringDictionary] | None = None,
        capacity: int | None = None,
    ) -> "ColumnBatch":
        n = len(next(iter(data.values()))) if data else 0
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        dicts = dict(dicts or {})
        cols: dict[str, Any] = {}
        for f in schema.fields:
            arr = encode_column(np.asarray(data[f.name]), f, dicts)
            if cap > n:
                pad = np.zeros(cap - n, dtype=arr.dtype)
                arr = np.concatenate([arr, pad])
            cols[f.name] = arr
        sel = np.zeros(cap, dtype=np.bool_)
        sel[:n] = True
        return ColumnBatch(schema, cols, sel, dicts)

    @staticmethod
    def from_pandas(df, schema: Schema | None = None,
                    dicts: dict[str, StringDictionary] | None = None,
                    capacity: int | None = None) -> "ColumnBatch":
        if schema is None:
            schema = _infer_schema(df)
        data = {f.name: df[f.name].to_numpy() for f in schema.fields}
        return ColumnBatch.from_arrays(data, schema, dicts, capacity)

    def decoded_columns(self) -> dict[str, np.ndarray]:
        """Selected rows as decoded host arrays (NULLs as None in object
        arrays) — pandas-free, safe off the main thread (the arrow-backed
        DataFrame constructor is not)."""
        sel = np.asarray(self.sel)
        out = {}
        for f in self.schema.fields:
            arr = np.asarray(self.columns[f.name])[sel]
            vm = self.validity.get(f.name)
            invalid = None
            if vm is not None:
                invalid = ~np.asarray(vm).astype(bool)[sel]
                if f.dtype == DType.STRING and invalid.any():
                    # NULL string lanes may hold out-of-dictionary codes
                    # (e.g. -1 from CASE NULL branches): clamp before decode
                    arr = np.where(invalid, 0, arr)
                    d = self.dicts.get(f.name)
                    if d is not None and len(d) == 0:
                        out[f.name] = np.full(len(arr), None, dtype=object)
                        continue
            col = decode_column(arr, f, self.dicts)
            if invalid is not None and invalid.any():
                col = np.asarray(col, dtype=object)
                col[invalid] = None
            out[f.name] = col
        return out

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.decoded_columns())


def encode_column(arr: np.ndarray, f: Field,
                  dicts: dict[str, StringDictionary]) -> np.ndarray:
    """Host value array → physical device representation for field ``f``."""
    if f.dtype == DType.STRING and arr.dtype.kind in ("U", "S", "O"):
        d = dicts.setdefault(f.name, StringDictionary())
        arr = d.encode(arr)
    elif f.dtype == DType.DATE and arr.dtype.kind in ("U", "S", "O", "M"):
        if arr.dtype.kind == "M":
            arr = arr.astype("datetime64[D]").astype(np.int64)
        else:
            arr = np.fromiter((date_to_days(v) for v in arr), dtype=np.int64)
    elif f.dtype == DType.DECIMAL and arr.dtype.kind == "f":
        arr = np.rint(arr * (10.0 ** f.type.scale)).astype(np.int64)
    elif f.dtype == DType.DECIMAL and arr.dtype.kind in "iu":
        arr = arr.astype(np.int64) * np.int64(10 ** f.type.scale)
    return arr.astype(f.type.np_dtype)


def decode_column(arr: np.ndarray, f: Field,
                  dicts: dict[str, StringDictionary]) -> np.ndarray:
    """Physical representation → host values (dict decode, date, descale)."""
    if f.dtype == DType.STRING and f.name in dicts:
        return dicts[f.name].decode(arr)
    if f.dtype == DType.DATE:
        return arr.astype("datetime64[D]")
    if f.dtype == DType.DECIMAL:
        return arr.astype(np.float64) / (10.0 ** f.type.scale)
    return arr


def _infer_schema(df) -> Schema:
    fields = []
    for name in df.columns:
        k = df[name].dtype.kind
        if k == "b":
            t = types.BOOL
        elif k == "i" and df[name].dtype.itemsize <= 4:
            t = types.INT32
        elif k in ("i", "u"):
            t = types.INT64
        elif k == "f":
            t = types.FLOAT64
        elif k == "M":
            t = types.DATE
        else:
            t = types.STRING
        fields.append(Field(name, t))
    return Schema(tuple(fields))
