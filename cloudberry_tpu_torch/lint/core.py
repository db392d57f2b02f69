"""graftlint core — findings, suppressions, file collection, run_lint.

The analyzer never crashes on bad input: a file that does not parse
becomes a ``syntax`` FINDING (file:line of the error) and is skipped by
the passes. Suppression is per-site: a ``# graftlint: ignore[rule]``
comment on the finding's line (or on the line above, for findings on
multi-line statements) suppresses that rule there; the text after the
bracket is the justification the clean gate requires.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ignore\[([a-z0-9_,\s-]+)\]\s*(.*)")


@dataclass
class Finding:
    rule: str
    file: str                # repo-relative path
    line: int
    message: str
    suppressed: bool = False
    justification: str = ""

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.file}:{self.line}: {self.rule}: {self.message}{tag}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "suppressed": self.suppressed,
                "justification": self.justification}


@dataclass
class Suppression:
    rules: tuple
    justification: str
    used: bool = False


class LintModule:
    """One parsed source file: AST + per-line suppressions. ``tree`` is
    None when the file failed to parse (the syntax finding already
    reported it)."""

    def __init__(self, path: str, relpath: str):
        self.path = path
        self.relpath = relpath
        self.tree: ast.AST | None = None
        self.lines: list[str] = []
        self.suppressions: dict[int, Suppression] = {}
        self.parse_error: Finding | None = None
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                src = f.read()
        except OSError as e:
            self.parse_error = Finding(
                "syntax", relpath, 1, f"unreadable file: {e}")
            return
        self.lines = src.splitlines()
        for i, text in self._comment_lines(src):
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                self.suppressions[i] = Suppression(
                    rules, m.group(2).strip(" —-:"))
        try:
            self.tree = ast.parse(src, filename=relpath)
        except (SyntaxError, ValueError) as e:
            line = getattr(e, "lineno", 1) or 1
            self.parse_error = Finding(
                "syntax", relpath, int(line),
                f"file does not parse: {getattr(e, 'msg', e)}")

    @staticmethod
    def _comment_lines(src: str):
        """(line, text) for REAL comment tokens only — a docstring that
        merely mentions the ``# graftlint: ignore[...]`` syntax must not
        register as a suppression (or as a stale one)."""
        import io
        import tokenize

        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(src).readline):
                if tok.type == tokenize.COMMENT:
                    yield tok.start[0], tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # unparseable tail: the syntax finding covers the file; any
            # comments tokenized before the error were already yielded
            return

    def suppression_for(self, rule: str, line: int) -> Suppression | None:
        """The suppression governing ``rule`` at ``line``: same line
        first, then the line directly above (for findings anchored to a
        multi-line statement's first line)."""
        for ln in (line, line - 1):
            s = self.suppressions.get(ln)
            if s is not None and (rule in s.rules or "all" in s.rules):
                return s
        return None


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)
    modules: list[LintModule] = field(default_factory=list)
    # pass artifacts (the lock graph rides here for --dot)
    lock_graph: dict = field(default_factory=dict)
    lock_sites: dict = field(default_factory=dict)

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    def rule_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.unsuppressed:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def summary(self) -> dict:
        return {"findings": len(self.unsuppressed),
                "suppressions": len(self.suppressed),
                "files": len(self.modules),
                "rules": self.rule_counts()}


def collect_files(paths, cfg) -> list[tuple[str, str]]:
    """(abs path, repo-relative path) for every in-scope .py file. The
    relative root is the deepest common parent so rule scoping by
    module suffix (serve/server.py, ...) works from any invocation
    directory."""
    out = []
    for root in paths:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            # anchor the relative path at the package root (walk up
            # through __init__.py parents) so suffix-scoped rules
            # (serve/server.py, exec/kernels.py, ...) still apply to a
            # single-file invocation
            base = os.path.dirname(root)
            while os.path.exists(os.path.join(base, "__init__.py")):
                base = os.path.dirname(base)
            rel = os.path.relpath(root, base).replace(os.sep, "/")
            if cfg.in_scope(rel):
                out.append((root, rel))
            continue
        base = os.path.dirname(root.rstrip(os.sep))
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in cfg.exclude_dirs)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                p = os.path.join(dirpath, fn)
                rel = os.path.relpath(p, base).replace(os.sep, "/")
                if cfg.in_scope(rel):
                    out.append((p, rel))
    return out


def run_lint(paths, cfg=None) -> LintResult:
    """Run every pass over ``paths`` (files or directories). Never
    raises for bad INPUT (syntax errors become findings); programming
    errors in the passes themselves do propagate — the gate must fail
    loudly, not mask itself."""
    from cloudberry_tpu_torch.lint.config import LintConfig
    from cloudberry_tpu_torch.lint.passes import locks, obs, planprops, seams
    from cloudberry_tpu_torch.lint.passes import taxonomy, tracepurity

    cfg = cfg if cfg is not None else LintConfig()
    result = LintResult()
    raw: list[Finding] = []
    for path, rel in collect_files(paths, cfg):
        mod = LintModule(path, rel)
        result.modules.append(mod)
        if mod.parse_error is not None:
            raw.append(mod.parse_error)
    parsed = [m for m in result.modules if m.tree is not None]
    raw += locks.run(parsed, cfg, result)
    raw += tracepurity.run(parsed, cfg)
    raw += taxonomy.run(parsed, cfg)
    raw += seams.run(parsed, cfg)
    raw += obs.run(parsed, cfg)
    raw += planprops.run(parsed, cfg)

    by_file = {m.relpath: m for m in result.modules}
    for f in raw:
        mod = by_file.get(f.file)
        if mod is not None:
            s = mod.suppression_for(f.rule, f.line)
            if s is not None:
                f.suppressed = True
                f.justification = s.justification
                s.used = True
    # suppression hygiene is part of the gate, not just the test suite:
    # a suppression that matched nothing is itself a finding (the code
    # it excused was refactored away, and leaving the comment would
    # silently swallow the NEXT finding on that line), and a matching
    # suppression with NO justification fails too — the policy is
    # "a bare tag fails", and the CLI/CI gate must enforce it exactly
    # like tests/test_lint_clean.py does
    for mod in result.modules:
        for ln, s in sorted(mod.suppressions.items()):
            if not s.used:
                raw.append(Finding(
                    "unused-suppression", mod.relpath, ln,
                    f"suppression for [{', '.join(s.rules)}] matches no "
                    "finding — delete the stale ignore comment"))
            elif not s.justification.strip():
                raw.append(Finding(
                    "unjustified-suppression", mod.relpath, ln,
                    f"suppression for [{', '.join(s.rules)}] has no "
                    "justification — say WHY the site is deliberately "
                    "exempt after the bracket"))
    result.findings = sorted(raw, key=lambda f: (f.file, f.line, f.rule))
    return result


def lock_graph_dot(result: LintResult) -> str:
    """The static acquisition-order graph as Graphviz dot (documentation
    artifact; cycles would have been findings)."""
    lines = ["digraph lock_order {", "  rankdir=LR;",
             '  node [shape=box, fontsize=10];']
    nodes = set()
    for a, edges in sorted(result.lock_graph.items()):
        nodes.add(a)
        for b in edges:
            nodes.add(b)
    for n in sorted(nodes):
        lines.append(f'  "{n}";')
    for a, edges in sorted(result.lock_graph.items()):
        for b, site in sorted(edges.items()):
            lines.append(f'  "{a}" -> "{b}" '
                         f'[label="{site[0]}:{site[1]}", fontsize=8];')
    lines.append("}")
    return "\n".join(lines)
