"""prelude_ms: the cycle trace rows' ``prelude_ms``, mean over the window's
ticks."""

from crane_bench.metrics._rows import mean_of


def read(ctx):
    return mean_of(ctx, "prelude_ms")
