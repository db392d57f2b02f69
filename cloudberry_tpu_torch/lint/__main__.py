"""graftlint CLI — ``python -m cloudberry_tpu_torch.lint [paths...]``.

Exit codes: 0 = clean (no unsuppressed findings), 1 = findings,
2 = usage error. Output is one finding per line (``file:line: rule:
message``); ``--json`` switches to a machine-readable document and
``--dot`` prints the static lock-acquisition graph instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from cloudberry_tpu_torch.lint.core import lock_graph_dot, run_lint

    ap = argparse.ArgumentParser(
        prog="python -m cloudberry_tpu_torch.lint",
        description="project-invariant static analysis "
                    "(lock discipline, trace purity, taxonomy, seams)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint "
                         "(default: the cloudberry_tpu_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings document")
    ap.add_argument("--dot", action="store_true",
                    help="print the lock-acquisition graph (Graphviz)")
    ap.add_argument("--rule", action="append", default=None,
                    help="restrict output to these rule ids")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include suppressed findings in the output")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    paths = args.paths
    if not paths:
        import cloudberry_tpu_torch

        paths = [os.path.dirname(os.path.abspath(
            cloudberry_tpu_torch.__file__))]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"no such path: {', '.join(missing)}", file=sys.stderr)
        return 2

    result = run_lint(paths)

    # one gate for every output mode: all unsuppressed findings, or —
    # under --rule — only the selected rules (the exit code must never
    # fail on findings the invocation does not report)
    gate = result.unsuppressed
    shown = result.unsuppressed + (
        result.suppressed if args.show_suppressed else [])
    suppressed = result.suppressed
    if args.rule:
        allowed = set(args.rule)
        gate = [f for f in gate if f.rule in allowed]
        shown = [f for f in shown if f.rule in allowed]
        suppressed = [f for f in suppressed if f.rule in allowed]
    shown.sort(key=lambda f: (f.file, f.line, f.rule))

    if args.dot:
        print(lock_graph_dot(result))
        return 1 if gate else 0

    # the summary describes what THIS invocation gates on — a --rule
    # scope must not report global counts next to a filtered list
    rules: dict[str, int] = {}
    for f in gate:
        rules[f.rule] = rules.get(f.rule, 0) + 1
    summary = {"findings": len(gate), "suppressions": len(suppressed),
               "files": len(result.modules),
               "rules": dict(sorted(rules.items()))}
    if args.json:
        print(json.dumps({
            "summary": summary,
            "findings": [f.as_dict() for f in shown],
        }, indent=1))
    else:
        for f in shown:
            print(f.render())
        print(f"graftlint: {summary['findings']} finding(s), "
              f"{summary['suppressions']} suppressed, "
              f"{summary['files']} file(s)")
    return 1 if gate else 0


if __name__ == "__main__":
    sys.exit(main())
