"""Mean per statement of the client's latency less the server session's
statement wall (its root span), in ms: the wire, the event loop and
rendering. Each answered request is matched to the statement of its
text that started and ended inside it."""


def read(ctx):
    t = ctx.tracer
    if t is None or not t.on_card:
        return None
    stmts = t.statements()
    used = [False] * len(stmts)
    gaps = []
    for r in ctx.window.answered():
        sql = r.sql[:200]
        for i, s in enumerate(stmts):
            if used[i] or s["t0"] < r.t_send:
                continue
            if s["t0"] > r.t_recv:
                break
            if s["t1"] <= r.t_recv and s["sql"] == sql:
                used[i] = True
                gaps.append((r.t_recv - r.t_send) - (s["t1"] - s["t0"]))
                break
    if not gaps:
        return None
    return 1000.0 * sum(gaps) / len(gaps)
