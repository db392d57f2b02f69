"""Statement classification shared by every read-only gate.

Three consumers ask "can this statement change state?": the Session's
failure-recovery retry (a replayed write double-applies), the hot
standby (must refuse writes), and the MCP query tool (agents get reads
only). One classifier keeps them agreeing — they diverged once already
(nextval: head says SELECT, but sequence allocation happens at plan time
and durably advances the sequence file)."""

from __future__ import annotations

import re

READ_HEADS = frozenset(
    {"select", "with", "values", "explain", "show", "retrieve"})

_STRING_LIT = re.compile(r"'(?:[^']|'')*'")


def strip_string_literals(sql: str) -> str:
    """SQL with quoted literals blanked — so classification never trips
    on keyword-looking or punctuation-looking text inside strings."""
    return _STRING_LIT.sub("''", sql)


def read_only(sql: str) -> bool:
    """True when re-running the statement cannot change engine state."""
    s = sql.lstrip()
    bare = strip_string_literals(s).lower()
    if "nextval" in bare:
        return False  # plan-time sequence allocation is a durable write
    if s.startswith("("):
        return True  # parenthesized set operation — a query by grammar
    head = s.split(None, 1)
    return bool(head) and head[0].lower() in READ_HEADS
