"""Statement skeletons — the query-fingerprint half of generic plans.

The JAX package's ``sched/paramplan.py`` makes same-shape statements share
one compiled program (the plan_cache.c analog): ``normalize`` hoists a
statement's constant literals into a parameter vector and keys the plan
cache on the remaining SKELETON. The port carries ``normalize`` only: the
statements table (obs/statements.py) aggregates per skeleton, and the
flight recorder (obs/flightrec.py) fingerprints the hoisted literals.
Generic plans themselves (the plan signature, the literal rebind and the
statement cache) are not ported yet; any other name of this module raises
``NotImplementedError``.
"""

from __future__ import annotations

from cloudberry_tpu_torch.sql.lexer import LexError, tokenize


_PARAM_HEADS = ("select", "with", "(")
# literals after these keywords are STRUCTURAL (plan shape / bind-time
# folds), never parameters: LIMIT/OFFSET become static node fields and
# INTERVAL quantities fold into date arithmetic at bind time
_KEEP_AFTER = ("limit", "offset", "interval")


def normalize(sql: str):
    """(skeleton, literal texts) for a parameterizable statement, else
    None. The skeleton is the token stream with number/string literals
    replaced by kind-tagged placeholders — same-shape statements collide
    on it regardless of their literal values."""
    head = sql.lstrip()[:1]
    if not head:
        return None
    first = sql.split(None, 1)[0].lower() if head != "(" else "("
    if first not in _PARAM_HEADS:
        return None
    try:
        toks = tokenize(sql)
    except LexError:
        return None
    parts: list[str] = []
    params: list[str] = []
    prev = ""
    for t in toks:
        if t.kind == "number" and prev not in _KEEP_AFTER:
            params.append(t.text)
            parts.append("?n")
        elif t.kind == "string" and prev not in _KEEP_AFTER:
            params.append(t.text)
            parts.append("?s")
        elif t.kind == "string":
            parts.append(f"'{t.text}'")
        elif t.kind != "eof":
            parts.append(t.text)
        prev = t.text if t.kind == "ident" else ""
    return " ".join(parts), tuple(params)


def __getattr__(name: str):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"sched.paramplan.{name}: generic plans are not yet ported")
