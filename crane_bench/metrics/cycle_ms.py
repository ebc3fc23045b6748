"""cycle_ms: the client's wall time of ``Tick``, summed over the window's
ticks and divided by their count."""


def read(ctx):
    return sum(t["wall_ms"] for t in ctx.ticks) / len(ctx.ticks)
