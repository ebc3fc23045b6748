"""solve_head_ms: the cycle trace rows' ``solve_head_ms``, mean over the window's
ticks."""

from crane_bench.metrics._rows import mean_of


def read(ctx):
    return mean_of(ctx, "solve_head_ms")
