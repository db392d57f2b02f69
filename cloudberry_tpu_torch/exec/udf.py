"""Scalar user-defined functions — the procedural-language seam.

The reference ships whole PL runtimes (src/pl/plpgsql, plpython, plperl)
running per-tuple inside the executor. The JAX package, a one-XLA-program
executor, offers the three shapes that compile there, and the port keeps
them so both engines accept the same functions:

- **constant folding**: immutable functions over constant arguments
  evaluate host-side at bind time (the preprocess_expression /
  eval_const_expressions role);
- **dictionary rewrite**: a function over ONE dictionary-encoded string
  column evaluates host-side over the dictionary's VALUES (small), and
  the per-row work lowers to a gather through the result table — the
  same machinery LIKE/substring predicates use (plan/binder.py
  DictLookup). Any Python callable works, string→string or
  string→scalar;
- **tensor functions** (``jit=True``): the callable takes and returns
  torch tensors on the session's device and runs inside the Lowerer's
  walk (exec/expr_compile.py) — the port's counterpart of the JAX
  package's traced function (the reference's C-language function
  analog, minus the FFI).

``register_function(name, fn, arg_types, ret)`` is the CREATE FUNCTION
analog; the registry is process-global like the table-function hook
(exec/tablefunc.py). Its version (``registry_version``) is part of the
statement cache's and the generic plans' validity keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from cloudberry_tpu_torch import types as T
from cloudberry_tpu_torch.types import SqlType


@dataclass(frozen=True)
class Udf:
    name: str
    fn: Callable
    arg_types: tuple
    ret: SqlType
    volatility: str = "immutable"   # immutable | volatile
    jit: bool = False               # fn maps torch tensors to a tensor


_UDFS: dict[str, Udf] = {}
# bumped on every (un)registration: UDF results bake into plans at bind
# time (constant fold, dictionary tables), so cached statements must
# invalidate when a function changes — the CREATE OR REPLACE semantics
_VERSION = 0


def registry_version() -> int:
    return _VERSION


def register_function(name: str, fn: Callable, arg_types, ret: SqlType,
                      volatility: str = "immutable",
                      jit: bool = False) -> None:
    """CREATE FUNCTION analog. ``arg_types``/``ret`` are
    cloudberry_tpu_torch.types SQL types; ``jit=True`` promises fn maps
    torch tensors (one per argument, on the session's device) to a torch
    tensor (it runs inside the plan's lowering);
    ``volatility='volatile'`` disables constant folding AND the
    dictionary rewrite (both evaluate fewer times than once-per-row)."""
    global _VERSION

    if volatility not in ("immutable", "volatile"):
        raise ValueError(f"unknown volatility {volatility!r}")
    _UDFS[name.lower()] = Udf(name.lower(), fn, tuple(arg_types), ret,
                              volatility, jit)
    _VERSION += 1


def unregister_function(name: str) -> None:
    global _VERSION

    if _UDFS.pop(name.lower(), None) is not None:
        _VERSION += 1


def lookup(name: str) -> Optional[Udf]:
    return _UDFS.get(name.lower())


def known_functions() -> list[str]:
    return sorted(_UDFS)


def py_value(value, dtype: SqlType):
    """Literal payload → the Python value the function sees (decimals
    are stored as scaled ints; strings arrive as str)."""
    if dtype.base == T.DType.DECIMAL and value is not None:
        return value / 10 ** dtype.scale
    return value


def encode_result(value, dtype: SqlType):
    """Function result → literal payload (rescale decimals, validate)."""
    if value is None:
        return None
    if dtype.base == T.DType.DECIMAL:
        return int(round(float(value) * 10 ** dtype.scale))
    if dtype.base in (T.DType.INT32, T.DType.INT64, T.DType.DATE):
        return int(value)
    if dtype.base == T.DType.FLOAT64:
        return float(value)
    if dtype.base == T.DType.BOOL:
        return bool(value)
    if dtype.base == T.DType.STRING:
        return str(value)
    raise ValueError(f"UDF return type {dtype} unsupported")
