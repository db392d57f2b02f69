"""Helpers the port's parity tests share: carry a JAX session's tables into
a port session, and hold two results equal.

Equality: the same column names, dtypes, dictionaries, selected row count
and NULL masks; int, DECIMAL (int64 cents), count, date, bool and string
(dictionary code) values exactly where valid. float64 values within
``rtol * |want| + ATOL_PER_MAGNITUDE * M``: windowed float sums are
differences of prefix sums (S[hi] - S[lo]), whose rounding follows the
prefix's magnitude, not the result's, and the cumsums of XLA's CPU, PyTorch's
CPU and PyTorch's CUDA need not agree in the last bits. M, the column's sum
of absolute values, bounds the prefix magnitude of every query here.
"""

import numpy as np

from cloudberry_tpu_torch.catalog import carry
from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy

# the Pallas function each port kernel replaces
PALLAS_OF = {"dense_agg": "dense_agg_tiles_pallas",
             "probe_join": "probe_join_pallas",
             "sorted_seg": "sorted_seg_pallas"}
FLOAT_RTOL = 1e-9
ATOL_PER_MAGNITUDE = 1e-12


def carry_tables(js, ts, names=None) -> None:
    """Install the JAX session's tables (all, or ``names``) in the port
    session, encoded arrays unchanged."""
    for name, t in js.catalog.tables.items():
        if names is not None and name not in names:
            continue
        fields = [carry.field(f.name, f.type.base.value, f.type.scale,
                              f.nullable) for f in t.schema.fields]
        carry.load_encoded(ts, name, fields, t.data, t.validity,
                           {c: d.values for c, d in t.dicts.items()},
                           DistributionPolicy(t.policy.kind, t.policy.keys))


def count_calls(monkeypatch, module, names) -> dict:
    """Count the calls of module attributes: {key: attribute name}."""
    calls = {k: 0 for k in names}

    def wrap(key, fn):
        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return counted

    for key, attr in names.items():
        monkeypatch.setattr(module, attr, wrap(key, getattr(module, attr)))
    return calls


def _valid(batch, name, sel):
    v = batch.validity.get(name)
    n = int(np.asarray(sel).sum())
    return np.ones(n, dtype=bool) if v is None \
        else np.asarray(v).astype(bool)[np.asarray(sel)]


def assert_same(got, want, allow_empty: bool = False) -> None:
    assert [f.name for f in got.schema.fields] == \
        [f.name for f in want.schema.fields]
    gsel, wsel = np.asarray(got.sel), np.asarray(want.sel)
    assert gsel.sum() == wsel.sum()
    assert allow_empty or wsel.sum() > 0
    for f in want.schema.fields:
        g = np.asarray(got.columns[f.name])[gsel]
        w = np.asarray(want.columns[f.name])[wsel]
        assert g.dtype == w.dtype, (f.name, g.dtype, w.dtype)
        gv, wv = _valid(got, f.name, gsel), _valid(want, f.name, wsel)
        np.testing.assert_array_equal(gv, wv, err_msg=f"{f.name} NULLs")
        g, w = g[wv], w[wv]
        if w.dtype.kind == "f":
            atol = ATOL_PER_MAGNITUDE * max(1.0, float(np.abs(w).sum()))
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=atol,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        gd, wd = got.dicts.get(f.name), want.dicts.get(f.name)
        if wd is not None:
            assert list(gd.values) == list(wd.values), f.name


class Pair:
    """A JAX session and a port session (on the CPU) over the same
    statements: ``sql`` runs a statement in both and holds the results
    equal — a SELECT's batches by ``assert_same``, any other statement's
    status text exactly."""

    def __init__(self, jcfg, tcfg):
        import cloudberry_tpu as cb
        from cloudberry_tpu_torch import Session as TorchSession

        self.jcfg, self.tcfg = jcfg, tcfg
        self.js = cb.Session(jcfg)
        self.ts = TorchSession(tcfg, device="cpu")

    def sql(self, query: str, allow_empty: bool = True):
        want = self.js.sql(query)
        got = self.ts.sql(query)
        if hasattr(want, "num_rows"):
            assert_same(got, want, allow_empty=allow_empty)
        else:
            assert got == want, (got, want)
        return got, want

    def reopen(self) -> "Pair":
        """Fresh sessions over the same configs (stored tables register
        cold)."""
        return Pair(self.jcfg, self.tcfg)


def store_pair(tmp_path, rpp: int = 50, **overrides) -> Pair:
    """A Pair of store-backed sessions, each engine on a root of its own
    under ``tmp_path``: one segment, ``rpp`` rows per micro-partition,
    generic plans off in the JAX package (the port has none)."""
    import cloudberry_tpu as cb
    from cloudberry_tpu_torch import Config as TorchConfig

    common = {"storage.rows_per_partition": rpp, **overrides}
    jcfg = cb.config.Config(n_segments=1).with_overrides(**{
        "storage.root": str(tmp_path / "jax"),
        "sched.generic_plans": False, **common})
    tcfg = TorchConfig().with_overrides(**{
        "storage.root": str(tmp_path / "port"), **common})
    return Pair(jcfg, tcfg)


def plan_scans(session, sql: str) -> list:
    """The scans of a statement's optimized plan, in either engine."""
    pkg = type(session).__module__.split(".")[0]
    if pkg == "cloudberry_tpu":
        from cloudberry_tpu.exec.executor import scans_of
        from cloudberry_tpu.plan.binder import Binder
        from cloudberry_tpu.plan.planner import _optimize
        from cloudberry_tpu.sql.parser import parse_sql
    else:
        from cloudberry_tpu_torch.exec.executor import scans_of
        from cloudberry_tpu_torch.plan.binder import Binder
        from cloudberry_tpu_torch.plan.planner import _optimize
        from cloudberry_tpu_torch.sql.parser import parse_sql
    plan = _optimize(Binder(session.catalog).bind_query(parse_sql(sql)),
                     session)
    return list(scans_of(plan))
