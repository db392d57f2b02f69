"""Compile bound expressions to PyTorch — the ExprState bridge.

``compile_expr(e, device)`` returns a function of (columns: dict[str,
Tensor]) → Tensor, vectorized over the batch. JAX (with x64) promotes typed
operands the numpy way; PyTorch lets a 0-d tensor lose to a wider column
dtype. So binary operands are promoted explicitly (``_promote``) and every
arithmetic result is cast to its bound field's dtype.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.types import DType

Columns = dict[str, torch.Tensor]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(np_dtype)]


def compile_expr(e: ex.Expr, device) -> Callable[[Columns], torch.Tensor]:
    if isinstance(e, ex.ColumnRef):
        name = e.name
        return lambda cols: cols[name]

    if isinstance(e, ex.Literal):
        val = torch.as_tensor(np.asarray(e.value, dtype=e.dtype.np_dtype),
                              device=device)
        return lambda cols: val

    if isinstance(e, ex.Param):
        # runtime-bound literal (sched/paramplan.py): the Lowerer injects
        # the slot's value next to the columns — a 0-d tensor of the
        # literal's own dtype on the device, from the "$params" input — so
        # a generic plan re-runs with new literals through the same ops,
        # promotions included, as the literal it replaced. Without a
        # binding (a rewritten plan on the plan-per-text path: the growth
        # retry, a tiled step) the kept build-time value lowers exactly
        # as its Literal would.
        name = e.input_name
        if e.value is None:
            return lambda cols: cols[name]
        kept = np.asarray(e.value, dtype=e.dtype.np_dtype)
        return lambda cols: cols[name] if name in cols \
            else torch.as_tensor(kept, device=device)

    if isinstance(e, ex.BinOp):
        lf, rf = compile_expr(e.left, device), compile_expr(e.right, device)
        op = _BINOPS[e.op]
        if e.op in _ARITH:
            dt = torch_dtype(e.dtype.np_dtype)
            return lambda cols: op(lf(cols), rf(cols)).to(dt)
        return lambda cols: op(lf(cols), rf(cols))

    if isinstance(e, ex.UnaryOp):
        f = compile_expr(e.operand, device)
        if e.op == "not":
            return lambda cols: torch.logical_not(f(cols))
        if e.op == "-":
            return lambda cols: -f(cols)
        raise NotImplementedError(e.op)

    if isinstance(e, ex.Cast):
        f = compile_expr(e.operand, device)
        src, dst = e.operand.dtype, e.dtype
        dt = torch_dtype(dst.np_dtype)
        if src.base == DType.DECIMAL and dst.base == DType.FLOAT64:
            inv = 1.0 / (10.0 ** src.scale)
            return lambda cols: f(cols).to(dt) * inv
        if src.base == DType.FLOAT64 and dst.base == DType.DECIMAL:
            mul = 10.0 ** dst.scale
            return lambda cols: torch.round(f(cols) * mul).to(dt)
        if src.base == DType.DECIMAL and dst.base == DType.DECIMAL:
            if dst.scale >= src.scale:
                mul = 10 ** (dst.scale - src.scale)
                return lambda cols: f(cols) * mul
            return lambda cols: _scale_down(f(cols), src.scale - dst.scale)
        if src.base in (DType.INT32, DType.INT64) \
                and dst.base == DType.DECIMAL:
            mul = 10 ** dst.scale
            return lambda cols: f(cols).to(dt) * mul
        if src.base == DType.DECIMAL \
                and dst.base in (DType.INT32, DType.INT64):
            return lambda cols: _scale_down(f(cols), src.scale).to(dt)
        return lambda cols: f(cols).to(dt)

    if isinstance(e, ex.Func):
        return _compile_func(e, device)

    if isinstance(e, ex.CaseWhen):
        whens = [(compile_expr(c, device), compile_expr(v, device))
                 for c, v in e.whens]
        other = compile_expr(e.otherwise, device) \
            if e.otherwise is not None else None
        dt = torch_dtype(e.dtype.np_dtype)
        zero = torch.zeros((), dtype=dt, device=device)

        def run_case(cols):
            out = other(cols) if other is not None else zero
            # Evaluate in reverse so the FIRST matching WHEN wins.
            for cf, vf in reversed(whens):
                out = torch.where(cf(cols), *_promote(vf(cols), out))
            return out.to(dt)

        return run_case

    if isinstance(e, ex.DictLookup):
        f = compile_expr(e.column, device)
        table = torch.as_tensor(np.asarray(e.table), device=device)
        miss = torch.zeros((), dtype=torch.bool, device=device) \
            if table.dtype == torch.bool \
            else torch.full((), -1, dtype=table.dtype, device=device)

        def lookup(cols):
            codes = f(cols)
            # code -1 (value absent from dictionary) must not match
            safe = codes.clamp(0, table.shape[0] - 1).to(torch.int64)
            return torch.where(codes >= 0, table[safe], miss)

        return lookup

    if isinstance(e, ex.IsValid):
        names, neg = e.mask_names, e.negate

        def valid(cols):
            # mask columns may be bool or 0/1 ints (agg companions)
            v = cols[names[0]].to(torch.bool)
            for n in names[1:]:
                v = torch.logical_and(v, cols[n].to(torch.bool))
            return torch.logical_not(v) if neg else v

        return valid

    raise NotImplementedError(type(e).__name__)


def _promote(a: torch.Tensor, b: torch.Tensor):
    """numpy-style promotion of two typed operands (a 0-d literal keeps
    its own dtype's weight, as in JAX with typed numpy literals)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _scale_down(x: torch.Tensor, k: int) -> torch.Tensor:
    """Rounded (half away from zero) integer division by 10**k — rescales a
    decimal product back to its result scale."""
    if k == 0:
        return x
    d = 10 ** k
    half = 10 ** k // 2
    return torch.where(x >= 0, _floordiv(x + half, d),
                       -_floordiv(-x + half, d))


def _compile_func(e: ex.Func, device):
    args = [compile_expr(a, device) for a in e.args]
    name = e.name
    if name == "extract_year":
        # days-since-epoch → civil year (vectorized Hinnant algorithm).
        return lambda cols: _civil_from_days(args[0](cols))[0]
    if name == "extract_month":
        return lambda cols: _civil_from_days(args[0](cols))[1]
    if name == "abs":
        return lambda cols: torch.abs(args[0](cols))
    if name == "sqrt":
        # guard tiny negative values from the stddev identity's cancellation
        return lambda cols: torch.sqrt(args[0](cols).clamp_min(0.0))
    if name == "scale_down":
        # args: (decimal expr, literal k) — binder-inserted rescale after
        # decimal multiplication.
        k = int(e.args[1].value)  # type: ignore[attr-defined]
        return lambda cols: _scale_down(args[0](cols), k)
    if name.startswith("udf:"):
        # tensor scalar UDF (exec/udf.py, ``jit=True``): the registered
        # callable runs on the argument tensors inside the walk
        from cloudberry_tpu_torch.exec import udf as U

        u = U.lookup(name[4:])
        if u is not None and u.jit:
            fn = u.fn
            return lambda cols: fn(*[a(cols) for a in args])
    raise NotImplementedError(f"function {name}")


def _civil_from_days(z):
    """days since 1970-01-01 → (year, month, day); Howard Hinnant's
    branchless civil-from-days, exact for all int32 days."""
    z = z.to(torch.int64) + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _safe_div(a, b):
    # SQL raises on division by zero; masked-out lanes may legitimately hold
    # zeros, so evaluate total-function style: 0 for zero divisors. Integer
    # operands divide in float64 (JAX true_divide under x64).
    a, b = _promote(a, b)
    if not a.dtype.is_floating_point:
        a, b = a.to(torch.float64), b.to(torch.float64)
    nz = b != 0
    q = a / torch.where(nz, b, torch.ones_like(b))
    return torch.where(nz, q, torch.zeros_like(q))


def _safe_mod(a, b):
    # SQL modulo truncates toward zero (fmod semantics), unlike Python's
    # floor-mod; zero divisors evaluate total-function style like _safe_div.
    a, b = _promote(a, b)
    nz = b != 0
    r = torch.fmod(a, torch.where(nz, b, torch.ones_like(b)))
    return torch.where(nz, r, torch.zeros_like(r))


def _arith(fn):
    return lambda a, b: fn(*_promote(a, b))


def _logic(fn):
    return lambda a, b: fn(a.to(torch.bool), b.to(torch.bool))


_ARITH = ("+", "-", "*", "/", "%")

_BINOPS = {
    "+": _arith(torch.add),
    "-": _arith(torch.sub),
    "*": _arith(torch.mul),
    "/": _safe_div,
    "%": _safe_mod,
    "=": _arith(torch.eq),
    "<>": _arith(torch.ne),
    "<": _arith(torch.lt),
    "<=": _arith(torch.le),
    ">": _arith(torch.gt),
    ">=": _arith(torch.ge),
    "and": _logic(torch.logical_and),
    "or": _logic(torch.logical_or),
}
