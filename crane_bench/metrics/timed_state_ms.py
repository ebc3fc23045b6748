"""timed_state_ms: the ``timed_state`` span of the cycle trace rows'
``spans`` (the backfill head's time map from the run ledger's release rows,
and its dense batches), mean over the window's ticks that have one.  None
where the rows carry no such span."""


def read(ctx):
    vals = [s[3] - s[2] for t in ctx.ticks if t["row"]
            for s in t["row"].get("spans") or ()
            if s[0] == "timed_state" and s[3] is not None]
    return sum(vals) / len(vals) if vals else None
