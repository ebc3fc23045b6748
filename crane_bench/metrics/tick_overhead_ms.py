"""tick_overhead_ms: a Tick's wall time on the client less its cycle's own
wall time (the trace row's ``total_ms`` plus ``dispatch_ms``), mean over the
window's ticks: the RPC, the lock and the simulated plane's advance."""


def read(ctx):
    rows = [(t["wall_ms"], t["row"]) for t in ctx.ticks if t["row"]]
    if not rows:
        return None
    return sum(w - r["total_ms"] - r.get("dispatch_ms", 0.0)
               for w, r in rows) / len(rows)
