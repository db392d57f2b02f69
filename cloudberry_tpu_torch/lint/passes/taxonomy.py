"""Taxonomy-integrity pass — the wire-error contract, machine-checked.

The serving layer stamps every wire error with ``retryable`` and the
client trusts the taxonomy BY NAME (lifecycle._RETRYABLE_NAMES); these
invariants are what makes client auto-retry safe. Rules:

- ``tax-unstamped``: an error response dict literal (``"ok": False``)
  in a wire module without an explicit ``"retryable"`` key. An omitted
  stamp silently defaults to non-retryable on the client — a load-
  shedding refusal that forgets the stamp strands clients that should
  have failed over.
- ``tax-name-unknown``: a name in ``_RETRYABLE_NAMES`` (or the client's
  ``_CONN_SEVERING``) with no class definition anywhere in scope — the
  by-name contract would never match a live exception, so the retry
  silently stops applying.
- ``tax-retryable-mismatch``: a StatementError subclass whose
  ``retryable`` class attribute disagrees with its membership in
  ``_RETRYABLE_NAMES`` — the two classifier channels (isinstance walk
  and name registry) must give one verdict.
- ``tax-retryable-missing``: a StatementError subclass that never sets
  ``retryable`` explicitly — inheriting the default silently flips
  semantics when the hierarchy is refactored.
"""

from __future__ import annotations

import ast

from cloudberry_tpu_torch.lint.core import Finding


def _dict_keys(node: ast.Dict) -> dict[str, ast.AST]:
    out = {}
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            out[k.value] = v
    return out


def _str_set_literal(node: ast.AST) -> set[str] | None:
    """The string elements of a frozenset({...}) / {...} / (...) literal."""
    if isinstance(node, ast.Call) and node.args:
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
        if name in ("frozenset", "set", "tuple"):
            node = node.args[0]
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        out = set()
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.add(el.value)
        return out
    return None


def run(modules, cfg) -> list[Finding]:
    from cloudberry_tpu_torch.lint.config import RETRYABLE_NAMES_CONST

    findings: list[Finding] = []

    # ---- collect: every class name defined in scope, the taxonomy
    # module's name registry, StatementError subclasses + their stamps
    all_classes: set[str] = set()
    retryable_names: set[str] = set()
    retryable_src: tuple[str, int] | None = None
    conn_severing: dict[str, tuple[str, int]] = {}
    stmt_err_classes: list[tuple] = []  # (name, bases, stamp, file, line)

    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                all_classes.add(node.name)
                # attribute bases (lifecycle.StatementError) count by
                # their terminal name — the subtree rules must not be
                # dodged by importing the module instead of the class
                bases = [b.id if isinstance(b, ast.Name) else b.attr
                         for b in node.bases
                         if isinstance(b, (ast.Name, ast.Attribute))]
                stamp = None
                for stmt in node.body:
                    tgt = None
                    if isinstance(stmt, ast.Assign) \
                            and len(stmt.targets) == 1:
                        tgt, val = stmt.targets[0], stmt.value
                    elif isinstance(stmt, ast.AnnAssign) \
                            and stmt.value is not None:
                        # annotated form: retryable: bool = True
                        tgt, val = stmt.target, stmt.value
                    if isinstance(tgt, ast.Name) \
                            and tgt.id == "retryable" \
                            and isinstance(val, ast.Constant):
                        stamp = bool(val.value)
                stmt_err_classes.append(
                    (node.name, bases, stamp, mod.relpath, node.lineno))
            elif isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tname = node.targets[0].id
                if tname == RETRYABLE_NAMES_CONST \
                        and mod.relpath.endswith(cfg.taxonomy_module):
                    vals = _str_set_literal(node.value)
                    if vals is not None:
                        retryable_names = vals
                        retryable_src = (mod.relpath, node.lineno)
                elif tname == "_CONN_SEVERING":
                    vals = _str_set_literal(node.value)
                    if vals is not None:
                        for v in vals:
                            conn_severing[v] = (mod.relpath, node.lineno)

    # ---- rule: names must round-trip to real classes
    if retryable_src is not None:
        for name in sorted(retryable_names):
            if name not in all_classes:
                findings.append(Finding(
                    "tax-name-unknown", retryable_src[0],
                    retryable_src[1],
                    f"_RETRYABLE_NAMES entry {name!r} has no class "
                    "definition in scope — the by-name retry contract "
                    "can never match it"))
    for name, (file, line) in sorted(conn_severing.items()):
        if retryable_names and name not in retryable_names:
            findings.append(Finding(
                "tax-name-unknown", file, line,
                f"_CONN_SEVERING entry {name!r} is not in "
                "_RETRYABLE_NAMES — a severing refusal the client "
                "will not retry"))

    # ---- rule: StatementError subtree consistency with the registry
    base_of = {name: set(bases)
               for name, bases, _s, _f, _l in stmt_err_classes}

    def descends_stmt_error(name: str, seen=()) -> bool:
        if name == "StatementError":
            return True
        if name in seen:
            return False
        return any(descends_stmt_error(b, seen + (name,))
                   for b in base_of.get(name, ()))

    if retryable_names:
        for name, bases, stamp, file, line in stmt_err_classes:
            if name == "StatementError" \
                    or not descends_stmt_error(name):
                continue
            if stamp is None:
                findings.append(Finding(
                    "tax-retryable-missing", file, line,
                    f"StatementError subclass {name} never sets "
                    "``retryable`` explicitly — the wire verdict would "
                    "silently follow whatever the hierarchy inherits"))
                continue
            in_registry = name in retryable_names
            if stamp != in_registry:
                findings.append(Finding(
                    "tax-retryable-mismatch", file, line,
                    f"{name}.retryable={stamp} but the name "
                    f"{'is' if in_registry else 'is NOT'} in "
                    "_RETRYABLE_NAMES — the isinstance and by-name "
                    "classifier channels disagree"))

    # ---- rule: wire error dicts carry the explicit stamp
    for mod in modules:
        if not any(mod.relpath.endswith(w) for w in cfg.wire_modules):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Dict):
                continue
            keys = _dict_keys(node)
            ok = keys.get("ok")
            if ok is None or not isinstance(ok, ast.Constant) \
                    or ok.value is not False:
                continue
            if "retryable" not in keys:
                findings.append(Finding(
                    "tax-unstamped", mod.relpath, node.lineno,
                    "wire error response without an explicit "
                    "\"retryable\" stamp — the client defaults the "
                    "verdict to non-retryable; stamp it (False is a "
                    "decision, omission is an accident)"))
    return findings
