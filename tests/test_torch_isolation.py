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


def test_unported_paths_raise():
    import cloudberry_tpu_torch as ct

    s = ct.Session(device="cpu")
    s.sql("create table t (a int, b text)")
    s.sql("insert into t values (1, 'x'), (2, 'y')")
    with pytest.raises(NotImplementedError):
        s.sql("begin")
    with pytest.raises(NotImplementedError):
        s.sql("select nosuchfunc(a) from t")
    with pytest.raises(NotImplementedError):
        s.sql("create materialized view mv as select a from t")
    with pytest.raises(NotImplementedError):
        s.sql("create external table ext (a int) location "
              "('file:///nonexistent.csv')")
    out = s.sql("select b, sum(a) as s from t group by b order by b")
    assert out.decoded_columns()["s"].tolist() == [1, 2]
    # window functions run in the port
    out = s.sql("select a, row_number() over (order by a desc) as r from t "
                "order by a")
    assert out.decoded_columns()["r"].tolist() == [2, 1]
