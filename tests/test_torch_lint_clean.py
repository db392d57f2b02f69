"""The port's graftlint gate, the twin of ``tests/test_lint_clean.py``
over ``cloudberry_tpu_torch/``.

``python -m cloudberry_tpu_torch.lint cloudberry_tpu_torch/`` exits 0 —
zero unsuppressed findings — and every suppression carries a
justification. The fault-point inventory, the declared lock order and the
plan verifier's tables are held against the port's live modules. The
port's gate is its ``__main__``; ``tools/lint_gate.py`` stays the JAX
package's.
"""

import ast
import functools
import json
import os
import subprocess
import sys

import cloudberry_tpu_torch
from cloudberry_tpu_torch.lint import run_lint

PKG = os.path.dirname(os.path.abspath(cloudberry_tpu_torch.__file__))
REPO = os.path.dirname(PKG)


@functools.lru_cache(maxsize=1)
def _result():
    return run_lint([PKG])


def test_port_is_finding_free():
    result = _result()
    msgs = [f.render() for f in result.unsuppressed]
    assert not msgs, "graftlint findings:\n" + "\n".join(msgs)


def test_every_suppression_has_a_justification():
    result = _result()
    bare = [f.render() for f in result.suppressed
            if not f.justification.strip()]
    assert not bare, ("suppressions without a justification:\n"
                      + "\n".join(bare))
    # the JAX package's three justified sites, restored in the port
    sites = {(os.path.relpath(f.file, REPO).replace(os.sep, "/"), f.rule)
             for f in result.suppressed}
    assert sites >= {
        ("cloudberry_tpu_torch/exec/tiled.py", "seam-loop"),
        ("cloudberry_tpu_torch/exec/tiled_dist.py", "seam-loop"),
        ("cloudberry_tpu_torch/serve/cron.py", "lock-unguarded")}, sites


def test_port_gate_exit_codes(tmp_path):
    """``python -m cloudberry_tpu_torch.lint`` over the port exits 0 and
    its JSON document agrees with the in-process result; over a tree with
    a finding it exits 1."""
    def gate(*args):
        return subprocess.run(
            [sys.executable, "-m", "cloudberry_tpu_torch.lint", *args],
            capture_output=True, text=True, timeout=120, cwd=REPO)

    ok = gate("cloudberry_tpu_torch/", "--json")
    assert ok.returncode == 0, ok.stdout[-2000:] + ok.stderr[-2000:]
    doc = json.loads(ok.stdout)
    assert doc["summary"]["findings"] == 0 and doc["findings"] == []
    assert doc["summary"]["suppressions"] == len(_result().suppressed) >= 3
    assert doc["summary"]["files"] == len(_result().modules)
    (tmp_path / "b.py").write_text("def f(:\n")
    assert gate(str(tmp_path)).returncode == 1
    assert gate(str(tmp_path / "nope")).returncode == 2


def test_fault_point_inventory_in_sync():
    """Both-ways sync between the port's faultinject INVENTORY and its
    fault_point call sites."""
    from cloudberry_tpu_torch.utils.faultinject import INVENTORY

    sites = set()
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    fname = getattr(node.func, "id",
                                    getattr(node.func, "attr", ""))
                    if fname == "fault_point":
                        sites.add(node.args[0].value)
    assert sites == set(INVENTORY), (
        f"missing from INVENTORY: {sorted(sites - set(INVENTORY))}; "
        f"stale in INVENTORY: {sorted(set(INVENTORY) - sites)}")


def test_witness_order_covers_discovered_locks():
    """The declared order covers a healthy majority of the port's lock
    sites, and names no lock the port does not have."""
    from cloudberry_tpu_torch.lint.config import witness_ranks

    result = _result()
    ranks = witness_ranks()
    resolved = set()
    for name, (_f, _l, _kind, alias) in result.lock_sites.items():
        if name in ranks:
            resolved.add(name)
        elif alias and alias in ranks:
            resolved.add(alias)
    assert len(resolved) >= 15, (resolved, sorted(result.lock_sites))
    assert set(ranks) <= resolved, sorted(set(ranks) - resolved)


def test_planprops_rule_table_exhaustive_live():
    """The port's plan/verify.py RULES covers every PlanNode subclass
    importable from the port, both ways."""
    from cloudberry_tpu_torch.exec.tiled import _AccLeaf  # noqa: F401
    from cloudberry_tpu_torch.plan import nodes as N
    from cloudberry_tpu_torch.plan.verify import RULES

    def subclasses(cls):
        for sub in cls.__subclasses__():
            yield sub
            yield from subclasses(sub)

    live = {c.__name__ for c in subclasses(N.PlanNode)}
    assert live <= set(RULES), sorted(live - set(RULES))
    assert set(RULES) <= live, sorted(set(RULES) - live)


def test_planprops_mode_tables_agree_live():
    from cloudberry_tpu_torch.exec.recovery import REPLACEABLE
    from cloudberry_tpu_torch.exec.tiled import CHECKPOINT_MODES

    assert set(CHECKPOINT_MODES) == set(REPLACEABLE)
