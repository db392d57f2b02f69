"""The port's exec/kernels.py and expr_compile functions against their JAX
counterparts, on the same numpy-seeded inputs. Exact.

The port carries a u64 key as int64 with the sign bit flipped ("biased");
the helpers below map the reference's uint64/uint32 keys into that form
before comparing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudberry_tpu import types as JT
from cloudberry_tpu.exec import expr_compile as JE
from cloudberry_tpu.exec import kernels as JK
from cloudberry_tpu.plan import expr as jex
from cloudberry_tpu_torch import types as TT
from cloudberry_tpu_torch.exec import expr_compile as TE
from cloudberry_tpu_torch.exec import kernels as TK
from cloudberry_tpu_torch.plan import expr as tex


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def biased64(u):
    return (np.asarray(u).astype(np.uint64) ^ np.uint64(1 << 63)) \
        .view(np.int64)


def biased32(u):
    return (np.asarray(u).astype(np.uint32) ^ np.uint32(1 << 31)) \
        .view(np.int32)


def _cols(rng, n):
    f = rng.integers(-3, 3, n) * 0.5
    f[:4] = [-0.0, 0.0, -1.5, np.inf]
    return {
        "i64": rng.integers(-5, 5, n).astype(np.int64),
        "i32": rng.integers(-3, 3, n).astype(np.int32),
        "f64": f,
        "b": rng.random(n) < 0.5,
    }


# ------------------------------------------------------------ sort / pack

@pytest.mark.parametrize("desc", [None, (True, False, True, False),
                                  (False, True, False, True)])
def test_sort_indices_ties_and_directions(desc):
    rng = np.random.default_rng(1)
    n = 500
    c = _cols(rng, n)
    sel = rng.random(n) < 0.7
    order = ["i32", "f64", "b", "i64"]
    j = JK.sort_indices([jnp.asarray(c[k]) for k in order],
                        jnp.asarray(sel), descending=desc)
    t = TK.sort_indices([T(c[k]) for k in order], T(sel), descending=desc)
    np.testing.assert_array_equal(N(t), np.asarray(j))


def test_sort_key_order_matches():
    rng = np.random.default_rng(2)
    for k, v in _cols(rng, 200).items():
        ju = np.asarray(JK.sort_key_u64(jnp.asarray(v)))
        np.testing.assert_array_equal(N(TK.sort_key_u64(T(v))),
                                      biased64(ju), err_msg=k)


def test_pack_with_ranges_out_of_range_sentinel():
    rng = np.random.default_rng(3)
    n = 400
    a = rng.integers(-50, 50, n).astype(np.int64)
    b = rng.integers(0, 7, n).astype(np.int32)
    d = rng.integers(-10**12, 10**12, n).astype(np.int64)
    bsel = rng.random(n) < 0.3          # build ranges from a subset
    jr = JK.key_ranges([jnp.asarray(a), jnp.asarray(b), jnp.asarray(d)],
                       jnp.asarray(bsel))
    tr = TK.key_ranges([T(a), T(b), T(d)], T(bsel))
    for (jl, js), (tl, ts) in zip(jr, tr):
        assert int(tl) == int(biased64(np.asarray(jl)))
        assert int(ts) == int(np.asarray(js).view(np.int64))
    # probe rows outside the build ranges pack to the sentinel
    pa = rng.integers(-80, 80, n).astype(np.int64)
    jp = JK.pack_with_ranges([jnp.asarray(pa), jnp.asarray(b),
                              jnp.asarray(d)], jr)
    tp = TK.pack_with_ranges([T(pa), T(b), T(d)], tr)
    assert (np.asarray(jp) == np.uint64(2**64 - 1)).any()
    np.testing.assert_array_equal(N(tp), biased64(jp))


def test_pack_empty_selection_and_downcast32():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1000, 300).astype(np.int64)
    for sel in (np.zeros(300, bool), rng.random(300) < 0.5):
        jp = JK.pack_keys([jnp.asarray(a)], jnp.asarray(sel))
        tp = TK.pack_keys([T(a)], T(sel))
        np.testing.assert_array_equal(N(tp), biased64(jp))
        np.testing.assert_array_equal(N(TK.downcast32(tp)),
                                      biased32(JK.downcast32(jp)))


# ----------------------------------------------------------------- joins

def _join_inputs(rng, nb=300, npr=900, dup=False):
    bk1 = rng.permutation(600)[:nb].astype(np.int64)
    bk2 = (bk1 % 5).astype(np.int32)
    if dup:
        bk1[1], bk2[1] = bk1[0], bk2[0]
    bsel = rng.random(nb) < 0.8
    if dup:
        bsel[:2] = True
    pk1 = rng.integers(-20, 620, npr).astype(np.int64)
    pk2 = (pk1 % 5).astype(np.int32)
    psel = rng.random(npr) < 0.8
    return [bk1, bk2], bsel, [pk1, pk2], psel


@pytest.mark.parametrize("bits", [64, 32])
@pytest.mark.parametrize("dup", [False, True])
def test_join_lookup(bits, dup):
    rng = np.random.default_rng(5 + bits + dup)
    bk, bsel, pk, psel = _join_inputs(rng, dup=dup)
    j = JK.join_lookup([jnp.asarray(x) for x in bk], jnp.asarray(bsel),
                       [jnp.asarray(x) for x in pk], jnp.asarray(psel),
                       bits=bits)
    t = TK.join_lookup([T(x) for x in bk], T(bsel), [T(x) for x in pk],
                       T(psel), bits=bits)
    np.testing.assert_array_equal(N(t[0]), np.asarray(j[0]))
    np.testing.assert_array_equal(N(t[1]), np.asarray(j[1]))
    assert bool(t[2]) == bool(j[2]) == dup


@pytest.mark.parametrize("bits", [64, 32])
def test_join_expand(bits):
    rng = np.random.default_rng(9)
    bk = [rng.integers(0, 40, 200).astype(np.int64)]
    bsel = rng.random(200) < 0.9
    pk = [rng.integers(-5, 45, 300).astype(np.int64)]
    psel = rng.random(300) < 0.9
    for cap in (64, 2000):   # overflow (total > cap) and fit
        j = JK.join_expand([jnp.asarray(bk[0])], jnp.asarray(bsel),
                           [jnp.asarray(pk[0])], jnp.asarray(psel), cap,
                           bits=bits)
        t = TK.join_expand([T(bk[0])], T(bsel), [T(pk[0])], T(psel), cap,
                           bits=bits)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(N(a), np.asarray(b))


def test_gather_payload_limit_compact():
    rng = np.random.default_rng(10)
    c = rng.integers(-9, 9, 50).astype(np.int64)
    idx = rng.integers(0, 50, 80).astype(np.int32)
    m = rng.random(80) < 0.5
    np.testing.assert_array_equal(
        N(TK.gather_payload({"c": T(c)}, T(idx), T(m))["c"]),
        np.asarray(JK.gather_payload({"c": jnp.asarray(c)},
                                     jnp.asarray(idx), jnp.asarray(m))["c"]))
    sel = rng.random(80) < 0.6
    np.testing.assert_array_equal(N(TK.limit_mask(T(sel), 7, 3)),
                                  np.asarray(JK.limit_mask(jnp.asarray(sel),
                                                           7, 3)))
    tc, ts, tn = TK.compact({"c": T(idx)}, T(sel), 30)
    jc, js, jn = JK.compact({"c": jnp.asarray(idx)}, jnp.asarray(sel), 30)
    np.testing.assert_array_equal(N(tc["c"]), np.asarray(jc["c"]))
    np.testing.assert_array_equal(N(ts), np.asarray(js))
    assert int(tn) == int(jn)
    for n in (0, 7, 8, 9, 1000, 1 << 20):
        assert TK.rung_up(n) == JK.rung_up(n)


# ------------------------------------------------------------- group-by

def _agg_inputs(rng, n=700):
    keys = {"k1": rng.integers(0, 9, n).astype(np.int64),
            "k2": rng.integers(-2, 2, n).astype(np.int32)}
    vals = {"s64": rng.integers(-10**12, 10**12, n).astype(np.int64),
            "s32": rng.integers(-10**6, 10**6, n).astype(np.int32),
            "f": rng.normal(size=n),
            "nn": rng.random(n) < 0.5}
    sel = rng.random(n) < 0.75
    specs = [("sum", "s64"), ("sum", "s32"), ("sum", "f"), ("min", "s64"),
             ("max", "s32"), ("min", "f"), ("avg", "s64"), ("avg", "s32"),
             ("avg", "f"), ("count_nn", "nn"), ("count", "c")]
    return keys, vals, sel, specs


def _agg_vals(vals, specs, conv):
    out = {}
    for func, name in specs:
        out[name + func] = None if func == "count" else conv(vals[name])
    return out


def _specs(mod, specs):
    return [mod.AggSpec(f, n + f) for f, n in specs]


def _assert_cols(t: dict, j: dict, rtol=0.0):
    assert set(t) == set(j)
    for k in j:
        a, b = N(t[k]), np.asarray(j[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if a.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_group_layout():
    rng = np.random.default_rng(11)
    keys, _, sel, _ = _agg_inputs(rng)
    for cap in (10, 64):       # fewer slots than groups, and more
        j = JK.group_layout({k: jnp.asarray(v) for k, v in keys.items()},
                            jnp.asarray(sel), cap)
        t = TK.group_layout({k: T(v) for k, v in keys.items()}, T(sel), cap)
        for f in ("perm", "s_sel", "new_grp", "n_groups", "n_sel", "starts",
                  "ends", "valid"):
            np.testing.assert_array_equal(N(getattr(t, f)),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f)
        _assert_cols(t.out_keys, j.out_keys)


def test_group_aggregate():
    rng = np.random.default_rng(12)
    keys, vals, sel, specs = _agg_inputs(rng)
    j = JK.group_aggregate({k: jnp.asarray(v) for k, v in keys.items()},
                           _agg_vals(vals, specs, jnp.asarray),
                           _specs(JK, specs), jnp.asarray(sel), 64)
    t = TK.group_aggregate({k: T(v) for k, v in keys.items()},
                           _agg_vals(vals, specs, T), _specs(TK, specs),
                           T(sel), 64)
    _assert_cols(t[0], j[0])
    # float sums: the two cumsums may associate differently
    _assert_cols(t[1], j[1], rtol=1e-9)
    np.testing.assert_array_equal(N(t[2]), np.asarray(j[2]))
    assert int(t[3]) == int(j[3])


def test_group_aggregate_dense_and_global():
    rng = np.random.default_rng(13)
    _, vals, sel, specs = _agg_inputs(rng)
    gid = rng.integers(-1, 14, len(sel)).astype(np.int32)
    j, jo = JK.group_aggregate_dense(
        jnp.asarray(gid), 12, _agg_vals(vals, specs, jnp.asarray),
        _specs(JK, specs), jnp.asarray(sel), strategy="segment")
    t, to = TK.group_aggregate_dense(
        T(gid), 12, _agg_vals(vals, specs, T), _specs(TK, specs), T(sel))
    _assert_cols(t, j, rtol=1e-9)
    np.testing.assert_array_equal(N(to), np.asarray(jo))
    j = JK.global_aggregate(_agg_vals(vals, specs, jnp.asarray),
                            _specs(JK, specs), jnp.asarray(sel))
    t = TK.global_aggregate(_agg_vals(vals, specs, T), _specs(TK, specs),
                            T(sel))
    _assert_cols(t, j, rtol=1e-9)


# ---------------------------------------------------------- expressions

def _exprs(ex, Ty):
    """The same expression trees, built from either package's modules."""
    D2, D4, D0 = Ty.DECIMAL(2), Ty.DECIMAL(4), Ty.DECIMAL(0)
    c = lambda n, t: ex.ColumnRef(n, t)
    lit = lambda v, t: ex.Literal(v, t)
    d4 = c("d4", D4)
    return {
        "scale_down_neg": ex.Func("scale_down", (d4, lit(2, Ty.INT32)), D2),
        "dec_to_dec": ex.Cast(d4, Ty.DECIMAL(1)),
        "dec_widen": ex.Cast(c("d2", D2), D4),
        "dec_to_int": ex.Cast(c("d2", D2), Ty.INT64),
        "dec_to_f64": ex.Cast(c("d2", D2), Ty.FLOAT64),
        "f64_to_dec": ex.Cast(c("f", Ty.FLOAT64), D2),
        "int_to_dec": ex.Cast(c("i32", Ty.INT32), D2),
        "dec_mul": ex.BinOp("*", c("d2", D2), c("d2b", D2), D4),
        "dec_sub_lit": ex.BinOp("-", ex.Cast(lit(1, D0), D2), c("d2", D2),
                                D2),
        "int_div": ex.BinOp("/", ex.Cast(c("i64", Ty.INT64), Ty.FLOAT64),
                            ex.Cast(c("i32", Ty.INT32), Ty.FLOAT64),
                            Ty.FLOAT64),
        "f_div_zero": ex.BinOp("/", c("f", Ty.FLOAT64),
                               ex.Cast(c("i32", Ty.INT32), Ty.FLOAT64),
                               Ty.FLOAT64),
        "int_mod": ex.BinOp("%", c("i64", Ty.INT64),
                            ex.Cast(c("i32", Ty.INT32), Ty.INT64), Ty.INT64),
        "mixed_add": ex.BinOp("+", ex.Cast(c("i32", Ty.INT32), Ty.INT64),
                              lit(3_000_000_000, Ty.INT64), Ty.INT64),
        "int32_cmp_lit": ex.BinOp("<", c("i32", Ty.INT32),
                                  lit(1, Ty.INT32), Ty.BOOL),
        "date_minus": ex.BinOp("-", c("day", Ty.DATE), lit(90, Ty.INT32),
                               Ty.DATE),
        "year": ex.Func("extract_year", (c("day", Ty.DATE),), Ty.INT32),
        "month": ex.Func("extract_month", (c("day", Ty.DATE),), Ty.INT32),
        "neg": ex.UnaryOp("-", c("i64", Ty.INT64), Ty.INT64),
        "abs": ex.Func("abs", (c("d2", D2),), D2),
        "case": ex.CaseWhen(
            ((ex.BinOp(">", c("i64", Ty.INT64), lit(0, Ty.INT64), Ty.BOOL),
              c("i32", Ty.INT32)),), lit(-7, Ty.INT64), Ty.INT64),
        "and_or": ex.BinOp("or", ex.BinOp("and", c("b", Ty.BOOL),
                                          c("b2", Ty.BOOL), Ty.BOOL),
                           ex.UnaryOp("not", c("b", Ty.BOOL), Ty.BOOL),
                           Ty.BOOL),
        "dict_lookup": ex.DictLookup(c("code", Ty.STRING),
                                     np.asarray([True, False, True])),
        "dict_rank": ex.DictLookup(c("code", Ty.STRING),
                                   np.asarray([2, 0, 1], np.int32),
                                   Ty.INT32),
        "is_valid": ex.IsValid(("m1", "m2"), True),
    }


def _expr_cols(rng, n=300):
    day = rng.integers(-800_000, 800_000, n).astype(np.int32)
    day[:6] = [-1, 0, 59, 60, -719_468, -719_469]
    return {
        "d4": rng.integers(-10**9, 10**9, n).astype(np.int64),
        "d2": rng.integers(-10**7, 10**7, n).astype(np.int64),
        "d2b": rng.integers(-10**4, 10**4, n).astype(np.int64),
        "f": np.round(rng.normal(size=n) * 100, 3),
        "i32": rng.integers(-4, 4, n).astype(np.int32),
        "i64": rng.integers(-10**6, 10**6, n).astype(np.int64),
        "day": day,
        "b": rng.random(n) < 0.5, "b2": rng.random(n) < 0.5,
        "code": rng.integers(-1, 3, n).astype(np.int32),
        "m1": rng.random(n) < 0.8, "m2": rng.integers(0, 2, n),
    }


@pytest.mark.parametrize("name", sorted(_exprs(tex, TT)))
def test_expr_compile_matches(name):
    rng = np.random.default_rng(14)
    cols = _expr_cols(rng)
    je, te = _exprs(jex, JT)[name], _exprs(tex, TT)[name]
    jv = np.asarray(JE.compile_expr(je)(
        {k: jnp.asarray(v) for k, v in cols.items()}))
    tv = N(TE.compile_expr(te, "cpu")({k: T(v) for k, v in cols.items()}))
    assert tv.dtype == jv.dtype, (tv.dtype, jv.dtype)
    np.testing.assert_array_equal(tv, jv)
