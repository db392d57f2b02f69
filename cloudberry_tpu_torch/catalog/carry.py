"""Install tables that are already encoded — the state carried across.

A table's physical form is what both engines scan: int32 dictionary codes
for strings (with the dictionary's value list beside them), int64 fixed-point
cents for DECIMAL, int32 day numbers for DATE. ``load_encoded`` installs
such arrays in a session's catalog unchanged, so a table taken from another
engine's catalog (or a file of arrays) scans bit-identical inputs here.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy, Table
from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
from cloudberry_tpu_torch.types import DType, Field, Schema, SqlType


def field(name: str, base: str, scale: int = 0,
          nullable: bool = True) -> Field:
    """A Field from plain values: ``base`` is a DType value ("int64",
    "decimal", "string", ...)."""
    return Field(name, SqlType(DType(base), scale), nullable)


def load_encoded(session, name: str, fields: Sequence[Field],
                 columns: Mapping[str, np.ndarray],
                 validity: Mapping[str, np.ndarray] | None = None,
                 dict_values: Mapping[str, Sequence[str]] | None = None,
                 policy: DistributionPolicy | None = None) -> Table:
    """Create table ``name`` and install its encoded columns unchanged.

    ``columns`` holds each field's physical array (its dtype must be the
    field type's physical dtype); ``validity`` the per-column presence
    masks of nullable columns; ``dict_values`` each string column's
    dictionary, code order."""
    schema = Schema(tuple(fields))
    data = {}
    for f in schema.fields:
        arr = np.asarray(columns[f.name])
        if arr.dtype != f.type.np_dtype:
            raise TypeError(f"{name}.{f.name}: encoded dtype {arr.dtype} "
                            f"is not {f.type.np_dtype}")
        data[f.name] = arr.copy()
    dicts = {c: StringDictionary(vals)
             for c, vals in (dict_values or {}).items()}
    t = session.catalog.create_table(name, schema, policy)
    t.set_data(data, dicts,
               validity={c: np.asarray(v, dtype=np.bool_)
                         for c, v in (validity or {}).items()})
    return t
