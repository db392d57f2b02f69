"""Mean per statement of the ``queue-wait`` mark (admission and the
resource queue), in ms."""

from cbbench.metrics._spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, ("queue-wait",))
