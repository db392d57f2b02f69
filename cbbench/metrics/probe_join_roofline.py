"""probe_join's share of its roofline over the traced window, in % (the
least time of the bytes its launches need at the card's peak bandwidth
over its device time in the profiler)."""

from cbbench.metrics._roofline import share


def read(ctx):
    return share(ctx.tracer, "probe_join")
