"""Statements answered within the window per second of the window, at
the clients (host clock)."""


def read(ctx):
    if not ctx.on_card:
        return None
    return len(ctx.window.done()) / ctx.window.seconds
