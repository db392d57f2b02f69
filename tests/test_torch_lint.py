"""The port's graftlint (``cloudberry_tpu_torch/lint/``) against the JAX
package's, the twin of ``tests/test_lint.py``.

Every seeded-bug fixture of ``tests/test_lint.py`` goes through both
analyzers: its test runs as written (its assertions hold the JAX
analyzer), and each tree it lints is linted again by the port's analyzer,
whose findings must equal the JAX analyzer's by rule, file, line,
message, suppression and justification. The trace-purity fixtures sit at
``exec/kernels.py``, a kernel module of the JAX package; the port's own
kernel scope is empty (it has no traced body), so the twin gives the
port's pass that fixture module as its scope, and
``test_port_kernel_scope_is_empty`` pins the port's default.

The default-scope and CLI exit-code tests and the runtime witness
tests are written again over the port's modules.
"""

import ast
import os
import textwrap

import pytest

import test_lint as J
from cloudberry_tpu.lint.config import LintConfig as JaxLintConfig
from cloudberry_tpu_torch.lint import run_lint
from cloudberry_tpu_torch.lint.config import LintConfig

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_KERNEL_SCOPE = ("exec/kernels.py",)


def _fixture_tests() -> list:
    """The tests of tests/test_lint.py that lint a fixture tree."""
    with open(os.path.join(HERE, "test_lint.py")) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) \
                and node.name.startswith("test_") \
                and any(isinstance(n, ast.Call)
                        and getattr(n.func, "id", "") == "_lint_tree"
                        for n in ast.walk(node)):
            out.append(node.name)
    return out


def _key(result) -> list:
    def one(f, suppressed):
        return (f.rule, f.file, f.line, f.message, suppressed,
                f.justification)
    return sorted([one(f, False) for f in result.unsuppressed]
                  + [one(f, True) for f in result.suppressed])


FIXTURE_TESTS = _fixture_tests()


def test_every_fixture_test_is_twinned():
    assert len(FIXTURE_TESTS) >= 24, FIXTURE_TESTS


@pytest.mark.parametrize("name", FIXTURE_TESTS)
def test_fixture_findings_equal_jax(name, tmp_path, monkeypatch):
    compared = []
    real = J._lint_tree

    def twin(tmp, files):
        jres = real(tmp, files)
        tres = run_lint([str(tmp / "pkg")], LintConfig(
            exclude_files=frozenset(),
            kernel_modules=FIXTURE_KERNEL_SCOPE))
        assert _key(tres) == _key(jres), name
        assert [m.relpath for m in tres.modules] == \
            [m.relpath for m in jres.modules]
        compared.append(len(jres.findings))
        return jres

    monkeypatch.setattr(J, "_lint_tree", twin)
    getattr(J, name)(tmp_path)
    assert compared, f"{name} linted no tree"


def test_port_kernel_scope_is_empty(tmp_path):
    """The port's default config audits no module for trace purity: the
    fixture that the JAX package flags at its kernel module is silent."""
    root = tmp_path / "pkg"
    (root / "exec").mkdir(parents=True)
    (root / "exec" / "kernels.py").write_text(textwrap.dedent("""
        import jax
        import jax.numpy as jnp


        @jax.jit
        def bad_kernel(x):
            total = jnp.sum(x)
            return total.item()
    """))
    assert LintConfig().kernel_modules == ()
    port = run_lint([str(root)], LintConfig(exclude_files=frozenset()))
    jax = J.run_lint([str(root)], JaxLintConfig(exclude_files=frozenset()))
    assert not [f for f in port.findings if f.rule.startswith("purity-")]
    assert [f.rule for f in jax.findings] == ["purity-coerce"]


def test_default_scope_excludes_tests_and_pycache(tmp_path):
    root = tmp_path / "pkg"
    (root / "tests").mkdir(parents=True)
    (root / "__pycache__").mkdir()
    (root / "tests" / "test_x.py").write_text("def f(:\n")
    (root / "__pycache__" / "junk.py").write_text("def f(:\n")
    (root / "ok.py").write_text("X = 1\n")
    result = run_lint([str(root)])  # DEFAULT config
    assert [m.relpath for m in result.modules] == ["pkg/ok.py"]
    assert not result.findings


def test_cli_exit_codes(tmp_path, capsys):
    from cloudberry_tpu_torch.lint.__main__ import main

    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "a.py").write_text("X = 1\n")
    assert main([str(clean)]) == 0
    dirty = tmp_path / "dirty"
    dirty.mkdir()
    (dirty / "b.py").write_text("def f(:\n")
    assert main([str(dirty), "--json"]) == 1
    assert main([str(tmp_path / "nope")]) == 2
    out = capsys.readouterr().out
    assert '"syntax"' in out


# ---------------------------------------------------------- the witness


def test_witness_fires_on_constructed_violation():
    """A reversed acquisition of two DECLARED locks of the port is
    recorded with the offending pair; correct order stays silent."""
    from cloudberry_tpu_torch.exec.instrument import StatementLog
    from cloudberry_tpu_torch.lifecycle import CancelToken, CircuitBreaker
    from cloudberry_tpu_torch.lint import witness

    witness.install()
    try:
        witness.reset_violations()
        assert witness.witnessed_site_count() > 0
        cb = CircuitBreaker()           # rank 2
        log = StatementLog()            # rank 3
        tok = CancelToken()             # rank 4
        with cb._lock:
            with log._lock:
                with tok._lock:
                    pass
        assert witness.violations() == []
        with tok._lock:
            with cb._lock:
                pass
        vs = witness.violations()
        assert len(vs) == 1
        assert vs[0].acquiring == "CircuitBreaker._lock"
        assert vs[0].holding[-1][0] == "CancelToken._lock"
        witness.reset_violations()
        log2 = StatementLog()           # rank 3
        with tok._lock:                 # r4
            with log._lock:             # r3 — violation 1
                with log2._lock:        # r3 vs held r4/r3 — violation 2
                    pass
        assert len(witness.violations()) == 2
    finally:
        witness.uninstall()
        witness.reset_violations()


def test_witness_condition_wait_reacquire_is_clean():
    """Condition.wait releases and re-acquires through the proxy: no
    phantom violations over the port's tenant scheduler."""
    import threading as _t

    from cloudberry_tpu_torch.config import get_config
    from cloudberry_tpu_torch.lint import witness
    from cloudberry_tpu_torch.sched.tenancy import TenantScheduler

    witness.install()
    try:
        witness.reset_violations()
        sched = TenantScheduler(get_config().tenancy)
        done = []

        def consumer():
            for _ in range(20):
                done.extend(sched.pick(4))

        threads = [_t.Thread(target=consumer) for _ in range(2)]
        for th in threads:
            th.start()
        for i in range(10):
            sched.enqueue("gold", f"item{i}")
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert witness.violations() == []
    finally:
        witness.uninstall()
        witness.reset_violations()


def test_witness_wraps_import_time_module_locks():
    """The port's module-global locks (faultinject._lock) are swapped in
    place, enforced, and restored by uninstall()."""
    from cloudberry_tpu_torch.lifecycle import CircuitBreaker
    from cloudberry_tpu_torch.lint import witness
    from cloudberry_tpu_torch.lint.witness import WitnessedLock
    from cloudberry_tpu_torch.utils import faultinject

    witness.install()
    try:
        witness.reset_violations()
        assert isinstance(faultinject._lock, WitnessedLock)
        faultinject.fault_point("lint_witness_probe_seam")
        assert "lint_witness_probe_seam" in faultinject.known_fault_points()
        cb = CircuitBreaker()
        with faultinject._lock:
            with cb._lock:
                pass
        assert any(v.acquiring == "CircuitBreaker._lock"
                   for v in witness.violations())
    finally:
        witness.uninstall()
        witness.reset_violations()
    assert not isinstance(faultinject._lock, WitnessedLock)


def test_witness_rlock_reentry_allowed():
    import _thread

    from cloudberry_tpu_torch.lint import witness
    from cloudberry_tpu_torch.lint.witness import WitnessedLock

    witness.install()
    try:
        witness.reset_violations()
        wl = WitnessedLock(_thread.RLock(), "X", 2, reentrant=True)
        with wl:
            with wl:
                pass
        assert witness.violations() == []
    finally:
        witness.uninstall()
        witness.reset_violations()


def test_witness_ranks_the_cluster_join_lock():
    """The lock this port adds around the cluster join is a declared
    leaf, wrapped at import time like the other module locks."""
    from cloudberry_tpu_torch.lint import witness
    from cloudberry_tpu_torch.lint.config import witness_ranks
    from cloudberry_tpu_torch.lint.witness import WitnessedLock
    from cloudberry_tpu_torch.parallel import mesh

    assert witness_ranks()["mesh._dist_lock"] == 4
    witness.install()
    try:
        assert isinstance(mesh._dist_lock, WitnessedLock)
    finally:
        witness.uninstall()
        witness.reset_violations()
    assert not isinstance(mesh._dist_lock, WitnessedLock)
