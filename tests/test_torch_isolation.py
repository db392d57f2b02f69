"""The port stands alone: it imports neither JAX nor the JAX package, and
its Session never falls back to the CPU on its own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cloudberry_tpu_torch"


def _forbidden(mod: str) -> bool:
    return mod == "jax" or mod.startswith("jax.") or mod.startswith("jaxlib") \
        or mod == "cloudberry_tpu" or mod.startswith("cloudberry_tpu.")


def test_import_pulls_in_no_jax():
    code = ("import sys, cloudberry_tpu_torch\n"
            "import cloudberry_tpu_torch.exec.executor\n"
            "import cloudberry_tpu_torch.exec.cuda_kernels\n"
            "import cloudberry_tpu_torch.plan.planner\n"
            "import cloudberry_tpu_torch.catalog.carry\n"
            "import cloudberry_tpu_torch.tpch\n"
            "import cloudberry_tpu_torch.tpcds\n"
            "import cloudberry_tpu_torch.lifecycle\n"
            "import cloudberry_tpu_torch.native\n"
            "import cloudberry_tpu_torch.utils.faultinject\n"
            "import cloudberry_tpu_torch.utils.tde\n"
            "import cloudberry_tpu_torch.storage.iofault\n"
            "import cloudberry_tpu_torch.storage.micropartition\n"
            "import cloudberry_tpu_torch.storage.table_store\n"
            "import cloudberry_tpu_torch.sched.sharedcache\n"
            "import cloudberry_tpu_torch.plan.scanprune\n"
            "import cloudberry_tpu_torch.plan.pointlookup\n"
            "import cloudberry_tpu_torch.exec.bufferpool\n"
            "import cloudberry_tpu_torch.exec.joinindex\n"
            "import cloudberry_tpu_torch.exec.resource\n"
            "import cloudberry_tpu_torch.exec.tiled\n"
            "import cloudberry_tpu_torch.exec.tilepipe\n"
            "import cloudberry_tpu_torch.exec.scanpipe\n"
            "import cloudberry_tpu_torch.exec.recovery\n"
            "import cloudberry_tpu_torch.plan.distribute\n"
            "import cloudberry_tpu_torch.obs\n"
            "import cloudberry_tpu_torch.obs.metrics\n"
            "import cloudberry_tpu_torch.obs.trace\n"
            "import cloudberry_tpu_torch.obs.statements\n"
            "import cloudberry_tpu_torch.obs.progress\n"
            "import cloudberry_tpu_torch.obs.capacity\n"
            "import cloudberry_tpu_torch.obs.flightrec\n"
            "import cloudberry_tpu_torch.sched.paramplan\n"
            "import cloudberry_tpu_torch.sql.classify\n"
            "import cloudberry_tpu_torch.exec.instrument\n"
            "import cloudberry_tpu_torch.parallel.health\n"
            "import cloudberry_tpu_torch.parallel.topology\n"
            "import cloudberry_tpu_torch.session\n"
            "import cloudberry_tpu_torch.plan.matview\n"
            "import cloudberry_tpu_torch.storage.fdw\n"
            "import cloudberry_tpu_torch.storage.dirtable\n"
            "import cloudberry_tpu_torch.exec.endpoint\n"
            "import cloudberry_tpu_torch.utils.zorder\n"
            "import cloudberry_tpu_torch.sched\n"
            "import cloudberry_tpu_torch.sched.dispatcher\n"
            "import cloudberry_tpu_torch.sched.tenancy\n"
            "import cloudberry_tpu_torch.storage.ingest\n"
            "import cloudberry_tpu_torch.serve\n"
            "import cloudberry_tpu_torch.serve.server\n"
            "import cloudberry_tpu_torch.serve.asyncore\n"
            "import cloudberry_tpu_torch.serve.client\n"
            "import cloudberry_tpu_torch.serve.cron\n"
            "import cloudberry_tpu_torch.serve.meta\n"
            "import cloudberry_tpu_torch.mgmt.cli\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    bad = [m for m in out.stdout.split() if _forbidden(m)]
    assert bad == []
    assert "cloudberry_tpu_torch" in out.stdout.split()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        bad = [m for m in _imports(path) if _forbidden(m)]
        assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_session_without_cuda_raises(monkeypatch):
    import cloudberry_tpu_torch as ct

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.Session()
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.Session(device="cuda")
    assert ct.Session(device="cpu").device.type == "cpu"


def test_unported_paths_raise(tmp_path):
    """The statements that raised ``NotImplementedError`` in the port
    until the rest of the SQL surface was ported — transaction control,
    materialized views, CLUSTER, external / foreign / directory tables and
    parallel retrieve cursors — now run and give the JAX package's status
    texts and results; an unknown function stays the reference's
    BindError."""
    import sqlite3

    from torch_parity import twin

    (tmp_path / "e.csv").write_text("1|x\n2|y\n")
    db = str(tmp_path / "f.db")
    con = sqlite3.connect(db)
    con.execute("create table f (a integer)")
    con.execute("insert into f values (1), (3)")
    con.commit()
    con.close()

    def run(e):
        s = e.session(**{"storage.root": e.root()})
        s.sql("create table t (a int, b text)")
        s.sql("insert into t values (1, 'x'), (2, 'y')")
        for q in ("begin", "insert into t values (3, 'z')", "rollback",
                  "begin", "commit",
                  "create materialized view mv as select b, sum(a) as s "
                  "from t group by b",
                  "refresh materialized view mv",
                  "cluster t by (a)",
                  "create external table ext (a int, b text) location "
                  f"('file://{tmp_path}/e.csv')",
                  f"create foreign table ft (a int) server sqlite options "
                  f"(database '{db}', table 'f')",
                  "create directory table dt"):
            e.keep(s.sql(q))
        e.keep(s.sql("select b, s from mv order by b"))
        e.keep(s.sql("select t.a, ext.b from t join ext on t.a = ext.a "
                     "join ft on ft.a = t.a order by t.a"))
        e.keep(s.sql("select count(*) as n from dt"))
        info = s.sql("declare c parallel retrieve cursor for select a from t")
        e.keep([x["rows"] for x in info["endpoints"]])
        e.keep(s.retrieve("c", 0)["rows"])
        e.keep(s.sql("close c"))
        e.keep(s.sql("drop materialized view mv"))
        e.error(s.sql, "select nosuchfunc(a) from t")
        e.keep(s.sql("select b, sum(a) as s from t group by b order by b"))
        e.keep(s.sql("select a, row_number() over (order by a desc) as r "
                     "from t order by a"))
    got = twin(run, tmp_path)
    assert got[:5] == ["BEGIN", "INSERT 1", "ROLLBACK", "BEGIN", "COMMIT"]
    assert got[11].decoded_columns()["s"].tolist() == [1, 2]
    assert got[12].decoded_columns()["a"].tolist() == [1]
    assert got[-3][0] == "BindError" and "unknown function" in got[-3][1]
    assert got[-1].decoded_columns()["r"].tolist() == [2, 1]


def test_paramplan_carries_normalize_only():
    """``normalize`` equals the JAX package's; generic plans and the
    dispatcher's stacked launch (``prepare_one``, ``run_batch``,
    ``GenericPlan.rung_fn``) are ported and no longer raise; an unknown
    name is an AttributeError."""
    from cloudberry_tpu.sched import paramplan as JP
    from cloudberry_tpu_torch.sched import paramplan as TP

    for sql in ("select a from t where k = 42 and s = 'x' limit 5",
                "insert into t values (1)", "(select 1) union (select 2)",
                "with q as (select 1.5 as x) select x from q", ""):
        assert TP.normalize(sql) == JP.normalize(sql)
    assert callable(TP.analyze) and callable(TP.lookup_or_build)
    for name in ("prepare_one", "run_batch"):
        assert callable(getattr(TP, name))
    assert callable(TP.GenericPlan.rung_fn)
    assert TP._next_pow2(5) == JP._next_pow2(5) == 8
    with pytest.raises(AttributeError):
        TP.__wrapped__
