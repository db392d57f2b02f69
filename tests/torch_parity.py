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
import torch

from cloudberry_tpu_torch.catalog import carry
from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy

# The suite runs in several worker processes on one machine's cores, and
# JAX compiles in every one of them: torch's intra-op threads (one per core
# in each worker) then oversubscribe the cores, and the small operators of
# the port's CPU runs spend their time waiting for one another (the
# distributed test files took 3.5x longer under six pytest-xdist workers).
# One thread per worker; every test module of the port imports this one.
torch.set_num_threads(1)

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


TILED_KEYS = ("mode", "tile_rows", "n_tiles", "acc_capacity",
              "est_step_bytes")


def budget_pair(load, budget=None, **overrides):
    """A JAX session (one segment, generic plans off) filled by
    ``load(session)`` and a port session on the CPU holding the same
    encoded tables, both under the same memory budget (None: the default
    4 GiB) and the same dotted ``overrides``."""
    import cloudberry_tpu as cb
    from cloudberry_tpu_torch import Config as TorchConfig
    from cloudberry_tpu_torch import Session as TorchSession

    ov = dict(overrides)
    if budget is not None:
        ov["resource.query_mem_bytes"] = budget
    js = cb.Session(cb.get_config().with_overrides(
        n_segments=1, **{"sched.generic_plans": False, **ov}))
    load(js)
    ts = TorchSession(TorchConfig().with_overrides(**ov), device="cpu")
    carry_tables(js, ts)
    return js, ts


def same_tiled_report(ts, js) -> dict:
    """The port's last tiled report, after holding its decision keys equal
    to the JAX session's (both must have tiled)."""
    tr, jr = ts.last_tiled_report, js.last_tiled_report
    assert tr is not None and jr is not None, (tr, jr)
    assert tr["tiled"] and jr["tiled"]
    for k in TILED_KEYS:
        assert tr.get(k) == jr.get(k), (k, tr.get(k), jr.get(k))
    retire_reference_decode_pool()
    return tr


# the distributed report's decision keys; timings and the pipeline's and
# the window's telemetry are compared apart
DIST_TILED_KEYS = TILED_KEYS + (
    "tiled", "distributed", "n_segments", "stream_table",
    "est_finalize_bytes", "est_pipeline_bytes", "budget_bytes",
    "tile_window", "resumed_from_tile", "tiles_replayed", "n_chunks",
    "topology_epoch")


def dist_pair(load, budget=None, nseg: int = 8, **overrides):
    """A JAX session and a port session on the CPU at ``nseg`` segments,
    generic plans off in the JAX package, the tables made by
    ``load(session)`` in the JAX session and carried into the port's,
    both under the same memory budget (None: the default 4 GiB) and the
    same dotted ``overrides``."""
    import cloudberry_tpu as cb
    from cloudberry_tpu_torch import Config as TorchConfig
    from cloudberry_tpu_torch import Session as TorchSession

    ov = {"n_segments": nseg, **overrides}
    if budget is not None:
        ov["resource.query_mem_bytes"] = budget
    js = cb.Session(cb.get_config().with_overrides(
        **{"sched.generic_plans": False, **ov}))
    load(js)
    ts = TorchSession(TorchConfig().with_overrides(**ov), device="cpu")
    carry_tables(js, ts)
    return js, ts


def same_dist_tiled_report(ts, js) -> dict:
    """The port's last distributed tiled report, after holding its key set
    and decision keys equal to the JAX session's (both must have tiled
    on the segment axis)."""
    tr, jr = ts.last_tiled_report, js.last_tiled_report
    assert tr is not None and jr is not None, (tr, jr)
    assert tr["tiled"] and tr["distributed"]
    assert set(tr) == set(jr), sorted(set(tr) ^ set(jr))
    for k in DIST_TILED_KEYS:
        assert tr.get(k) == jr.get(k), (k, tr.get(k), jr.get(k))
    retire_reference_decode_pool()
    return tr


def retire_reference_decode_pool() -> None:
    """Shut down the JAX package's process-wide column-decode pool, which
    its store-backed tiled runs create and keep: its worker threads carry
    the reference's ``cbtpu-`` prefix, and a JAX test that runs later in
    the same worker process asserts that no such thread is alive. Called
    between statements, when no reference feed holds the pool."""
    from cloudberry_tpu.exec import scanpipe as JSP

    with JSP._pool_lock:
        if JSP._pool is not None:
            JSP._pool.shutdown(wait=True)
            JSP._pool = None
            JSP._pool_workers = 0


def sorted_rows(batch):
    """A window-mode result as a DataFrame sorted by every column (a tiled
    window emits its rows chunk by chunk, in no SQL order)."""
    df = batch.to_pandas()
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def assert_same_rows(got, want, float_cols=()) -> None:
    """Window-mode results compared as the JAX package's spill test does:
    sorted by every column, other columns exact, ``float_cols`` within the
    stated float tolerance."""
    g, w = sorted_rows(got), sorted_rows(want)
    assert list(g.columns) == list(w.columns) and len(g) == len(w)
    exact = [c for c in w.columns if c not in float_cols]
    assert g[exact].equals(w[exact])
    for c in float_cols:
        wv = w[c].to_numpy(np.float64)
        atol = ATOL_PER_MAGNITUDE * max(1.0, float(np.abs(wv).sum()))
        np.testing.assert_allclose(g[c].to_numpy(np.float64), wv,
                                   rtol=FLOAT_RTOL, atol=atol, err_msg=c)


def strip_timings(text: str) -> str:
    """EXPLAIN ANALYZE text without what a clock measured: the
    ``Execution time:`` line and every ``<number> ms`` of a tiled
    trailer."""
    import re

    lines = [ln for ln in text.splitlines()
             if not ln.startswith("Execution time:")]
    out = re.sub(r"\d+(\.\d+)? ms", "<ms>", "\n".join(lines))
    return re.sub(r"overlap \d+%", "overlap <pct>", out)


def explain_analyze_session(load):
    """A JAX session on its default path (Pallas off: node text and
    counts do not depend on the kernels, and its Pallas dense path raises
    on TPC-H q4/q21, ROADMAP Queue C 5), no generic plans, filled by
    ``load(session)``, and a port session on the CPU holding the same
    encoded tables."""
    import cloudberry_tpu as cb
    from cloudberry_tpu_torch import Session as TorchSession

    js = cb.Session(cb.get_config().with_overrides(
        **{"exec.use_pallas": False, "sched.generic_plans": False}))
    load(js)
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    return js, ts


def held_explain_analyze(js, ts, sql: str, monkeypatch) -> str:
    """Hold the port's EXPLAIN ANALYZE of ``sql`` against the JAX
    session's, timings stripped, and against the port's own ``sql`` of
    the statement: the same kernel calls, the same number of times, and
    a root ``rows=`` equal to the result's row count. Returns the port's
    text."""
    import re

    from cloudberry_tpu_torch.exec import cuda_kernels as CK

    def calls_of(run):
        calls = count_calls(monkeypatch, CK, {k: k for k in PALLAS_OF})
        run()
        out = dict(calls)
        monkeypatch.undo()
        return out

    want = js.explain_analyze(sql)
    got = {}
    by_sql = calls_of(lambda: got.setdefault("batch", ts.sql(sql)))
    by_ea = calls_of(
        lambda: got.setdefault("text", ts.explain_analyze(sql)))
    text = got["text"]
    assert strip_timings(text) == strip_timings(want)
    assert by_ea == by_sql, (by_ea, by_sql)
    root = re.match(r"-> .*?rows=(\d+)", text.splitlines()[0])
    assert root is not None and int(root.group(1)) == \
        got["batch"].num_rows()
    return text


# EXPLAIN ANALYZE parity texts, spread over three test files so each
# stays near two minutes of test time in the tier-1 run (JAX compiles an
# instrumented program per text): every TPC-H text once, and seven
# TPC-DS texts, among them the window queries q12, q36 and q98
EA_TEXTS = {
    "test_torch_explain_analyze": (
        [f"q{i}" for i in (1, 2, 3, 4, 5, 6, 11, 12, 13, 14, 16, 22)],
        ["q3", "q42"]),
    "test_torch_explain_analyze_mid": (
        [f"q{i}" for i in (7, 8, 9, 10)], ["q12", "q55"]),
    "test_torch_explain_analyze_tail": (
        [f"q{i}" for i in (15, 17, 18, 19, 20, 21)],
        ["q36", "q52", "q98"]),
}
EA_WINDOWED = ("q12", "q36", "q98")


# ------------------------------------------------ fault seams, both engines


def arm_both(name: str, action: str = "error", **kw) -> None:
    """Arm the same fault point in the JAX package's and the port's
    registries."""
    from cloudberry_tpu.utils import faultinject as JFI
    from cloudberry_tpu_torch.utils import faultinject as TFI

    JFI.inject_fault(name, action, **kw)
    TFI.inject_fault(name, action, **kw)


def reset_both(name=None) -> None:
    from cloudberry_tpu.utils import faultinject as JFI
    from cloudberry_tpu_torch.utils import faultinject as TFI

    JFI.reset_fault(name)
    TFI.reset_fault(name)


def fired_both(name: str) -> tuple:
    """(hits, fired) of one armed seam in the JAX package and the port,
    which must be equal; returns the port's."""
    from cloudberry_tpu.utils import faultinject as JFI
    from cloudberry_tpu_torch.utils import faultinject as TFI

    j, t = JFI._registry.get(name), TFI._registry.get(name)
    got = (t.hits, t.fired) if t is not None else None
    want = (j.hits, j.fired) if j is not None else None
    assert got == want, (name, got, want)
    return got


# HealthMonitors a test started, in either engine: the chaos fixture stops
# them (their probe threads must not outlive the test)
MONITORS: list = []


def chaos_teardown() -> None:
    """After a fault-injection case: disarm both engines' seams, stop
    every HealthMonitor a test registered in MONITORS, and retire the
    reference's decode pool, so no armed fault or ``cbtpu-`` thread
    reaches a later test file on the same worker."""
    reset_both()
    while MONITORS:
        MONITORS.pop().stop()
    retire_reference_decode_pool()


def same_counters(ts, js, names) -> dict:
    """The named counters, equal in both engines; returns the port's."""
    got = {k: ts.stmt_log.counter(k) for k in names}
    want = {k: js.stmt_log.counter(k) for k in names}
    assert got == want, (got, want)
    return got


# ------------------------------------------- one scenario, both engines


class Engine:
    """One engine's side of a ``twin`` scenario: its package's modules,
    sessions on the CPU (the JAX package at one segment unless asked,
    generic plans off), a store root of its own under ``tmp``, and the
    values the scenario keeps for comparison."""

    def __init__(self, pkg: str, tmp=None):
        self.pkg = pkg
        self.tmp = tmp
        self.out: list = []

    @property
    def is_port(self) -> bool:
        return self.pkg == "cloudberry_tpu_torch"

    def mod(self, name: str):
        import importlib

        return importlib.import_module(f"{self.pkg}.{name}")

    @property
    def BindError(self):
        return self.mod("plan.binder").BindError

    def root(self, name: str = "store") -> str:
        return str(self.tmp / self.pkg / name)

    def config(self, n_segments: int = 1, **overrides):
        if self.is_port:
            from cloudberry_tpu_torch import Config as TorchConfig

            return TorchConfig(n_segments=n_segments).with_overrides(
                **overrides)
        import cloudberry_tpu as cb

        return cb.config.Config(n_segments=n_segments).with_overrides(
            **{"sched.generic_plans": False, **overrides})

    def session(self, n_segments: int = 1, **overrides):
        cfg = self.config(n_segments, **overrides)
        if self.is_port:
            from cloudberry_tpu_torch import Session as TorchSession

            return TorchSession(cfg, device="cpu")
        import cloudberry_tpu as cb

        return cb.Session(cfg)

    def keep(self, value):
        """Keep a value (a result batch, a status text, a flag) for the
        comparison; returns it."""
        self.out.append(value)
        return value

    def error(self, fn, *args, **kw):
        """Run ``fn`` expecting an exception; keeps and returns its type
        name and message (package names made equal)."""
        try:
            fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — the type is compared
            msg = str(e).replace("cloudberry_tpu_torch", "cloudberry_tpu")
            return self.keep((type(e).__name__, msg))
        raise AssertionError(f"{fn} raised nothing")


def _same_kept(got, want) -> None:
    if hasattr(want, "num_rows"):
        assert_same(got, want, allow_empty=True)
    elif isinstance(want, (list, tuple)) and want \
            and any(hasattr(w, "num_rows") for w in want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_kept(g, w)
    else:
        assert got == want, (got, want)


def twin(scenario, tmp=None) -> list:
    """Run ``scenario(engine)`` in the JAX package, then in the port, and
    hold every kept value equal (batches by ``assert_same``, anything else
    exactly); returns the port's kept values."""
    outs = []
    for pkg in ("cloudberry_tpu", "cloudberry_tpu_torch"):
        e = Engine(pkg, tmp)
        scenario(e)
        outs.append(e.out)
    want, got = outs
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        _same_kept(g, w)
    return got


# ------------------------------------------------ one scenario, two servers


# wire fields that legitimately differ between two runs of one request
# stream: statement ids, timings, random cursor tokens
_VOLATILE = {"id", "statement_id", "token", "wall_s", "elapsed_s",
             "started", "t0", "latency_ms"}


def wire_safe(resp):
    """A wire response with the volatile fields dropped (recursively) and
    package names made equal — what two engines must agree on."""
    if isinstance(resp, dict):
        return {k: wire_safe(v) for k, v in resp.items()
                if k not in _VOLATILE}
    if isinstance(resp, list):
        return [wire_safe(v) for v in resp]
    if isinstance(resp, str):
        return resp.replace("cloudberry_tpu_torch", "cloudberry_tpu")
    return resp


class WireEngine(Engine):
    """One engine's side of a ``twin_servers`` scenario: an ``Engine``
    whose servers (the package's ``Server``, on the CPU) and clients (the
    package's ``Client``) stop and close when the scenario ends."""

    def __init__(self, pkg: str, tmp=None):
        super().__init__(pkg, tmp)
        self._servers: list = []
        self._clients: list = []

    def server(self, session=None, config=None, start=True, **kw):
        Server = self.mod("serve.server").Server
        if session is None and self.is_port:
            kw.setdefault("device", "cpu")
        srv = Server(session=session, config=config, **kw)
        self._servers.append(srv)
        return srv.start() if start else srv

    def client(self, srv, **kw):
        c = self.mod("serve.client").Client(srv.host, srv.port, **kw)
        self._clients.append(c)
        return c

    @property
    def ServerError(self):
        return self.mod("serve.client").ServerError

    def wire(self, fn, *args, **kw):
        """Run one client call; keeps and returns its response with the
        volatile fields dropped, or the ServerError's (etype, retryable,
        message)."""
        try:
            return self.keep(wire_safe(fn(*args, **kw)))
        except self.ServerError as e:
            return self.keep(("ServerError", e.etype, e.retryable,
                              wire_safe(str(e))))

    def close(self) -> None:
        for c in self._clients:
            try:
                c.close()
            except OSError:
                pass
        for srv in self._servers:
            srv.stop()


def twin_servers(scenario, tmp=None) -> list:
    """Run ``scenario(engine)`` against a JAX package server on CPU JAX,
    then against a port server on the CPU, each with its own clients and
    store root (``engine.root()``), and hold every kept value equal;
    every server stops and every client closes, however the scenario
    ends. Returns the port's kept values."""
    outs = []
    for pkg in ("cloudberry_tpu", "cloudberry_tpu_torch"):
        e = WireEngine(pkg, tmp)
        try:
            scenario(e)
        finally:
            e.close()
        outs.append(e.out)
    want, got = outs
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        _same_kept(g, w)
    return got
