"""Geometric mean of the latency of every statement sent within the
window and answered, also after its close, in ms, at the clients (host clock): the form of TPC-H's power
metric, which weights a short template as much as a long one."""

import math


def read(ctx):
    done = ctx.window.answered()
    if not ctx.on_card or not done:
        return None
    logs = [math.log(1000.0 * (r.t_recv - r.t_send)) for r in done]
    return math.exp(sum(logs) / len(logs))
