"""wal_flush_ms: the sum of a tick's ``wal:flush`` spans (each WAL group's
write and fsync) in the cycle trace rows' ``spans``, mean over the window's
ticks whose rows carry spans.  None where none do."""


def read(ctx):
    vals = [sum(s[3] - s[2] for s in t["row"]["spans"]
                if s[0] == "wal:flush" and s[3] is not None)
            for t in ctx.ticks if t["row"] and t["row"].get("spans")]
    return sum(vals) / len(vals) if vals else None
