"""Shared by the readers of the program's cycle trace rows."""


def mean_of(ctx, key):
    """Mean of a trace-row field over the window's ticks that have it."""
    vals = [t["row"][key] for t in ctx.ticks
            if t["row"] and key in t["row"]]
    return sum(vals) / len(vals) if vals else None
