"""cycle_unnamed_ms: the self time of the cycle trace rows' ``cycle`` root
span (its duration less the union of its direct children's, from the row's
``spans``), mean over the window's ticks: the cycle's time in no named
phase.  None where the rows carry no spans."""


def unnamed_ms(spans):
    """Self time of the ``cycle`` root in one row's ``[name, parent,
    start, end]`` spans, or None without a closed root."""
    root = next((i for i, s in enumerate(spans)
                 if s[0] == "cycle" and s[1] == -1 and s[3] is not None),
                None)
    if root is None:
        return None
    r0, r1 = spans[root][2], spans[root][3]
    covered, reach = 0.0, r0
    kids = sorted((s for s in spans if s[1] == root and s[3] is not None),
                  key=lambda s: s[2])
    for _name, _parent, a, b in kids:
        a, b = max(a, reach), min(b, r1)
        if b > a:
            covered += b - a
            reach = b
    return r1 - r0 - covered


def read(ctx):
    vals = [unnamed_ms(t["row"]["spans"]) for t in ctx.ticks
            if t["row"] and t["row"].get("spans")]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
