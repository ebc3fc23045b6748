"""wal_bytes_per_tick: the cycle trace rows' ``wal_bytes`` (what the WAL
wrote in the cycle), mean over the window's ticks."""

from crane_bench.metrics._rows import mean_of


def read(ctx):
    return mean_of(ctx, "wal_bytes")
