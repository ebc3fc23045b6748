"""commit_ms.steady: the cycle trace rows' ``commit_ms``, mean over the window's
ticks."""

from crane_bench.metrics._rows import mean_of


def read(ctx):
    return mean_of(ctx, "commit_ms")
