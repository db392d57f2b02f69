"""The share of the traced window in which no operation ran on the card,
in %, from the profiler's device timeline."""


def read(ctx):
    t = ctx.tracer
    if t is None or not t.on_card or not t.window_s or t.busy_s is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
