"""Mean per statement of the front end's spans (parse, plan, compile),
in ms: the host work that the statement cache saves."""

from cbbench.metrics._spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, ("parse", "plan", "compile"))
