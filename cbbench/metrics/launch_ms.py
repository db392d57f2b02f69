"""Mean per statement of the ``launch`` span (from the program's start to
the result's host copy), in ms: the operators and kernels."""

from cbbench.metrics._spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, ("launch",))
