"""Statements of the traced window served from the statement cache or a
generic plan, in % of the statements that started in it (the program's
``stmt_cache_hits`` and ``generic_hits`` counters)."""


def read(ctx):
    t = ctx.tracer
    if t is None or not t.on_card:
        return None
    n = len(t.statements())
    if not n:
        return None
    hits = t.counters.get("stmt_cache_hits", 0) \
        + t.counters.get("generic_hits", 0)
    return 100.0 * hits / n
