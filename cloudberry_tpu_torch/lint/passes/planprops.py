"""planprops pass — the plan verifier's rule table, machine-checked.

plan/verify.py holds a per-node-class rule table deriving and
checking every plan node's distribution/capacity properties. The table
is only a net if it is EXHAUSTIVE — a PlanNode subclass without a rule
row is a node class the verifier silently cannot check, which is
exactly the failure mode the verifier exists to close. Rules:

- ``planprops-unruled``: a class deriving from PlanNode (anywhere in
  the package — plan/nodes.py or an executor-private leaf like
  exec/tiled.py's _AccLeaf) with no ``@rule("<Class>")`` registration
  in plan/verify.py. Anchored at the class definition.
- ``planprops-orphan-rule``: a ``@rule("<Name>")`` registration naming
  no existing PlanNode subclass — a stale row that would mask the
  unruled finding when the class is later re-added under a different
  shape. Anchored at the registration.
- ``planprops-ckpt-mode``: exec/tiled.py ``CHECKPOINT_MODES`` and
  exec/recovery.py ``REPLACEABLE`` must cover each other BOTH ways —
  a checkpointing tiled mode without a declared degraded-mesh
  re-placement rule resumes into a wrong answer; a re-placement rule
  for a mode nobody checkpoints is a stale contract.

Cross-module rules only fire when BOTH sides of a contract are in the
linted set (a single-file invocation of plan/nodes.py must not claim
every class is unruled just because verify.py was not handed in).
"""

from __future__ import annotations

import ast

from cloudberry_tpu_torch.lint.core import Finding


def _plannode_classes(tree: ast.AST) -> list[tuple[str, int]]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for b in node.bases:
            name = b.id if isinstance(b, ast.Name) \
                else getattr(b, "attr", "")
            if name == "PlanNode":
                out.append((node.name, node.lineno))
    return out


def _rule_rows(tree: ast.AST) -> list[tuple[str, int]]:
    """(class name, line) per ``@rule("Name", ...)`` registration in
    the verify module."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            fname = dec.func.id if isinstance(dec.func, ast.Name) \
                else getattr(dec.func, "attr", "")
            if fname != "rule":
                continue
            for a in dec.args:
                if isinstance(a, ast.Constant) and isinstance(a.value,
                                                              str):
                    out.append((a.value, dec.lineno))
    return out


def _const_tuple(tree: ast.AST, name: str):
    """(values, line) of a module-level ``NAME = ("a", "b", ...)``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            vals = [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)]
            return vals, node.lineno
    return None


def _const_dict_keys(tree: ast.AST, name: str):
    """(keys, line) of a module-level ``NAME = {"a": ..., ...}``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, ast.Dict):
            keys = [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)]
            return keys, node.lineno
    return None


def run(modules, cfg) -> list[Finding]:
    findings: list[Finding] = []
    verify_mod = next((m for m in modules
                       if m.relpath.endswith(cfg.plan_verify_module)),
                      None)
    classes: list[tuple[str, int, str]] = []   # (name, line, relpath)
    for mod in modules:
        for name, line in _plannode_classes(mod.tree):
            classes.append((name, line, mod.relpath))

    if verify_mod is not None:
        rows = _rule_rows(verify_mod.tree)
        ruled = {n for n, _ in rows}
        class_names = {n for n, _, _ in classes}
        for name, line, rel in classes:
            if name not in ruled:
                findings.append(Finding(
                    "planprops-unruled", rel, line,
                    f"PlanNode subclass {name!r} has no @rule row in "
                    "plan/verify.py — the plan verifier cannot derive "
                    "or check its properties; add a rule (or it ships "
                    "unverifiable)"))
        # classes must be visible for the orphan direction too — a
        # verify.py-only invocation has no class inventory to judge by
        if classes:
            for name, line in rows:
                if name not in class_names:
                    findings.append(Finding(
                        "planprops-orphan-rule", verify_mod.relpath,
                        line,
                        f"@rule({name!r}) names no PlanNode subclass "
                        "— delete the stale row (it would mask the "
                        "unruled finding if the class returns under a "
                        "different shape)"))

    tiled = next((m for m in modules
                  if m.relpath.endswith(cfg.tiled_module)), None)
    recov = next((m for m in modules
                  if m.relpath.endswith(cfg.recovery_module)), None)
    if tiled is not None and recov is not None:
        ck = _const_tuple(tiled.tree, "CHECKPOINT_MODES")
        rp = _const_dict_keys(recov.tree, "REPLACEABLE")
        if ck is None:
            findings.append(Finding(
                "planprops-ckpt-mode", tiled.relpath, 1,
                "exec/tiled.py no longer declares CHECKPOINT_MODES — "
                "the checkpointing-mode contract is unverifiable"))
        elif rp is None:
            findings.append(Finding(
                "planprops-ckpt-mode", recov.relpath, 1,
                "exec/recovery.py no longer declares REPLACEABLE — "
                "the re-placement contract is unverifiable"))
        else:
            modes, ck_line = ck
            keys, rp_line = rp
            for m in modes:
                if m not in keys:
                    findings.append(Finding(
                        "planprops-ckpt-mode", tiled.relpath, ck_line,
                        f"tiled mode {m!r} checkpoints but has no "
                        "re-placement rule in exec/recovery.py "
                        "REPLACEABLE — a degraded-mesh resume would "
                        "be wrong"))
            for k in keys:
                if k not in modes:
                    findings.append(Finding(
                        "planprops-ckpt-mode", recov.relpath, rp_line,
                        f"REPLACEABLE declares mode {k!r} which no "
                        "tiled executor checkpoints (stale rule)"))
    return findings
