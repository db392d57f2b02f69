"""Readers of the program's statement spans (obs/trace.py) in the traced
window."""


def mean_span_ms(ctx, names) -> float | None:
    """Mean per statement of the spans named ``names``, in ms (a
    statement without such a span counts 0)."""
    t = ctx.tracer
    if t is None or not t.on_card:
        return None
    stmts = t.statements()
    if not stmts:
        return None
    total = sum(s["spans"].get(n, 0.0) for s in stmts for n in names)
    return 1000.0 * total / len(stmts)
