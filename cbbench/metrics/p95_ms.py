"""95th percentile of the latency of every statement sent within the
window and answered, also after its close, in ms, at the clients (host clock); linear between ranks."""

import numpy as np


def read(ctx):
    done = ctx.window.answered()
    if not ctx.on_card or not done:
        return None
    lat = np.asarray([1000.0 * (r.t_recv - r.t_send) for r in done])
    return float(np.percentile(lat, 95))
