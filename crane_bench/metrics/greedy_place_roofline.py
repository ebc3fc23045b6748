"""greedy_place_roofline: the least time the immediate-fit solves of the
window need at the card's published peaks (``crane_bench/peaks.py``, work
counted from each tick's shapes: the jobs the solve is given, the nodes of
each job's partition, three resource dimensions) over the device time of
the kernels named ``greedy_place`` in the trace."""

from crane_bench import peaks

KERNEL = "greedy_place"


def read(ctx):
    tr = ctx.trace
    if not tr:
        return None
    kernel_s = sum(s for n, s in tr["by_name"].items() if KERNEL in n)
    if kernel_s <= 0:
        return None
    cfg = ctx.config
    nodes = int(cfg["nodes"])
    per_job = nodes // int(cfg["partitions"])
    sched = cfg["scheduler"]
    head = (int(sched.get("backfill_max_jobs", 1024))
            if sched.get("backfill", True) else 0)
    least = 0.0
    for t in ctx.ticks:
        row = t["row"]
        if not row or not row.get("kernel_launches"):
            continue
        jobs = max(int(row["candidates"]) - head, 0)
        least += peaks.least_seconds(
            *peaks.greedy_place_work(jobs, per_job, nodes))[0]
    return 100.0 * least / kernel_s
