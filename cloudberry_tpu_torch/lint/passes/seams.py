"""Seam-integrity pass — FAULT_POINT inventory sync + cancel seams.

The fault-injection seams are load-bearing test surface: chaos soaks arm
them by NAME, so a renamed call site silently stops being covered. The
inventory (utils/faultinject.INVENTORY) is the contract of record; this
pass keeps it honest in both directions. Rules:

- ``seam-unknown``: a ``fault_point("name")`` call site whose name is
  not in the inventory — the seam exists but no soak can know about it.
- ``seam-stale``: an inventory entry with no remaining call site — a
  test arming it would silently never fire.
- ``seam-dynamic``: a ``fault_point(expr)`` call with a non-literal
  name — unverifiable statically, and unarmable by a fixed soak config.
- ``seam-loop``: an unbounded ``while True`` tile/retry loop (in
  config.SEAM_LOOP_MODULES) with no cancellation seam in its body —
  cooperative cancellation has a blind spot exactly where statements
  spend their time. Pure structural walks (no calls beyond a small
  builtin whitelist) are exempt: they terminate with the plan tree.
"""

from __future__ import annotations

import ast

from cloudberry_tpu_torch.lint.core import Finding

# calls a bounded structural walk may make (plan-tree descent loops)
_WALK_OK_CALLS = frozenset({
    "isinstance", "len", "id", "append", "add", "index", "extend",
    "pop", "insert", "tuple", "list", "set", "str", "int", "getattr",
    "hasattr", "max", "min", "abs",
})


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def run(modules, cfg) -> list[Finding]:
    findings: list[Finding] = []

    # ---- collect fault_point call sites + the inventory literal
    sites: dict[str, list[tuple[str, int]]] = {}
    inventory: set[str] | None = None
    inv_src: tuple[str, int] | None = None
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and _call_name(node) == "fault_point" and node.args:
                # skip the declaration itself (def fault_point is not a
                # Call; recursive mentions inside faultinject are real)
                arg = node.args[0]
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    sites.setdefault(arg.value, []).append(
                        (mod.relpath, node.lineno))
                else:
                    findings.append(Finding(
                        "seam-dynamic", mod.relpath, node.lineno,
                        "fault_point() with a non-literal name — the "
                        "inventory cannot verify it and soaks cannot "
                        "arm it by name"))
            elif isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "INVENTORY" \
                    and mod.relpath.endswith(cfg.faultinject_module):
                from cloudberry_tpu_torch.lint.passes.taxonomy import (
                    _str_set_literal,
                )

                vals = _str_set_literal(node.value)
                if vals is not None:
                    inventory = vals
                    inv_src = (mod.relpath, node.lineno)

    if inventory is not None:
        for name in sorted(sites):
            if name not in inventory:
                file, line = sites[name][0]
                findings.append(Finding(
                    "seam-unknown", file, line,
                    f"fault_point({name!r}) is not in the faultinject "
                    "INVENTORY — add it so soaks and the chaos ladder "
                    "can arm it"))
        for name in sorted(inventory - set(sites)
                           - set(cfg.inventory_extra_ok)):
            findings.append(Finding(
                "seam-stale", inv_src[0], inv_src[1],
                f"INVENTORY entry {name!r} has no fault_point call "
                "site — a soak arming it would never fire; delete or "
                "re-declare the seam"))
    elif any(mod.relpath.endswith(cfg.faultinject_module)
             for mod in modules):
        for mod in modules:
            if mod.relpath.endswith(cfg.faultinject_module):
                findings.append(Finding(
                    "seam-stale", mod.relpath, 1,
                    "faultinject module has no INVENTORY literal — the "
                    "seam contract has no record"))

    # ---- unbounded loops must poll a cancel seam
    for mod in modules:
        if not any(mod.relpath.endswith(s)
                   for s in cfg.seam_loop_modules):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.While):
                continue
            test = node.test
            unbounded = isinstance(test, ast.Constant) \
                and test.value is True
            if not unbounded:
                continue
            has_seam = False
            saw_call = False
            only_walk_calls = True
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    saw_call = True
                    name = _call_name(sub)
                    if name in cfg.cancel_seam_calls:
                        has_seam = True
                        break
                    if name not in _WALK_OK_CALLS:
                        only_walk_calls = False
            # the walk exemption needs EVIDENCE of a walk (at least one
            # whitelisted call): a call-free while-True is a busy spin,
            # exactly what the rule exists to catch
            if has_seam or (saw_call and only_walk_calls):
                continue
            findings.append(Finding(
                "seam-loop", mod.relpath, node.lineno,
                "unbounded while-True loop without a cancellation seam "
                "(check_cancel/_raise_tile_checks) — a cancelled or "
                "over-deadline statement cannot stop here"))
    return findings
