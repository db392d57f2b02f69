"""Observability-integrity pass — the telemetry plane, machine-checked.

obs/metrics.MetricsRegistry is the ONE home for engine
counters (StatementLog.counters is a view into it) and the wire's
``meta`` verb list is the observability contract thin clients discover.
Rules:

- ``obs-counter-home``: a ``collections.Counter(...)`` instantiation
  outside ``obs/`` — a new ad-hoc counter store would fork the metric
  plane (no exposition, no ``meta "metrics"`` visibility, no bound).
  Count on the registry (``stmt_log.bump`` / ``registry.bump``) or a
  plain dict with an explicit snapshot surface instead.
- ``obs-gauge-home``: a ``gauge(...)``/``gauge_max(...)`` write outside
  ``obs/`` (the same contract as ``obs-counter-home``). Gauges
  are point-in-time values: one scattered across the engine goes stale
  invisibly the day its call site stops running. They live in
  obs/capacity.py's read-time refresh (or another obs/ module), where
  staleness is structurally impossible.
- ``obs-meta-verbs``: ``serve/meta.py``'s describe() docstring lists
  its kinds ("Kinds: a | b | ..."); the implemented ``kind == "..."``
  comparisons must match the documented list BOTH ways — an
  undocumented verb is invisible to clients, a documented-but-missing
  one is a lie in the contract.
"""

from __future__ import annotations

import ast
import re

from cloudberry_tpu_torch.lint.core import Finding


def _counter_calls(tree: ast.AST):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
        if name == "Counter":
            yield node


def _gauge_calls(tree: ast.AST):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
        if name in ("gauge", "gauge_max"):
            yield node


def _documented_kinds(doc: str) -> set[str] | None:
    """The 'Kinds: a | b | c.' list from describe()'s docstring."""
    m = re.search(r"Kinds:\s*(.*?)\.", doc, flags=re.S)
    if m is None:
        return None
    return {w.strip() for w in m.group(1).split("|") if w.strip()}


def _implemented_kinds(fn: ast.FunctionDef) -> set[str]:
    out = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        left = node.left
        if not (isinstance(left, ast.Name) and left.id == "kind"):
            continue
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, ast.Eq) and isinstance(comp, ast.Constant) \
                    and isinstance(comp.value, str):
                out.add(comp.value)
    return out


def run(modules, cfg) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        parts = mod.relpath.replace("\\", "/").split("/")
        in_obs = "obs" in parts[:-1]
        if not in_obs:
            for call in _counter_calls(mod.tree):
                findings.append(Finding(
                    "obs-counter-home", mod.relpath, call.lineno,
                    "collections.Counter instantiated outside obs/ — "
                    "engine counters live on the MetricsRegistry "
                    "(stmt_log.bump / registry.bump); an ad-hoc Counter "
                    "is invisible to meta \"metrics\" and the "
                    "Prometheus exposition"))
            for call in _gauge_calls(mod.tree):
                findings.append(Finding(
                    "obs-gauge-home", mod.relpath, call.lineno,
                    "gauge written outside obs/ — gauges are "
                    "point-in-time values that go stale invisibly when "
                    "scattered; set them from obs/capacity.py's "
                    "read-time refresh (or another obs/ module)"))
        if mod.relpath.endswith(cfg.meta_module):
            findings += _check_meta_verbs(mod)
    return findings


def _check_meta_verbs(mod) -> list[Finding]:
    findings: list[Finding] = []
    describe = next(
        (n for n in ast.walk(mod.tree)
         if isinstance(n, ast.FunctionDef) and n.name == "describe"),
        None)
    if describe is None:
        return findings
    doc = ast.get_docstring(describe) or ""
    documented = _documented_kinds(doc)
    if documented is None:
        return [Finding(
            "obs-meta-verbs", mod.relpath, describe.lineno,
            "describe() has no 'Kinds: ...' docstring list — the meta "
            "verb contract must be documented")]
    implemented = _implemented_kinds(describe)
    for kind in sorted(implemented - documented):
        findings.append(Finding(
            "obs-meta-verbs", mod.relpath, describe.lineno,
            f"meta kind {kind!r} is implemented but missing from "
            "describe()'s documented Kinds list"))
    for kind in sorted(documented - implemented):
        findings.append(Finding(
            "obs-meta-verbs", mod.relpath, describe.lineno,
            f"meta kind {kind!r} is documented but not implemented "
            "(no `kind == ...` branch)"))
    return findings
