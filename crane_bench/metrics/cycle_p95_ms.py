"""cycle_p95_ms: the 95th percentile of the window's Tick wall times
(nearest rank; the sample count is the window's tick count)."""

import math


def read(ctx):
    walls = sorted(t["wall_ms"] for t in ctx.ticks)
    return walls[max(0, math.ceil(0.95 * len(walls)) - 1)]
