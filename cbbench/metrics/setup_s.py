"""Seconds from the process's start to the window's: making the data on
the card, loading it into the program's session, building the kernels,
starting the server and warming the cell's statements."""


def read(ctx):
    if not ctx.on_card:
        return None
    return ctx.setup_s
