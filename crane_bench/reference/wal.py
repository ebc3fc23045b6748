"""A plain reader of the controller's write-ahead log: one JSON object a
line, ``{"seq", "ev", "job": {...}}``, read without the program's code.

Every line's event and job id are read from its head; a start record, and a
submit record whose job ``detail`` names, are parsed whole.  A line whose
head does not read so is parsed whole too.
"""

from __future__ import annotations

import json
import re

_HEAD = re.compile(r'\{"seq":\d+,"ev":"(\w+)","job":\{"job_id":(\d+),')


def _submit_fields(job: dict) -> tuple:
    spec = job["spec"]
    return (job["submit_time"], spec["res"]["cpu"], spec["res"]["mem_bytes"],
            spec["node_num"], spec["time_limit"], spec["partition"],
            spec["sim_runtime"])


def read(path: str, detail) -> dict:
    """``submit``: job id -> (submit time, cpus, memory bytes, node count,
    time limit, partition, runtime) for the jobs ``detail`` names, else
    None; ``start``: job id -> (start time, node ids) of its last start
    record; ``counts``: records by event; ``torn``: lines that do not
    parse."""
    submits, starts, counts, torn = {}, {}, {}, 0
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            head = _HEAD.match(line)
            if head is not None:
                ev, job_id = head.group(1), int(head.group(2))
                counts[ev] = counts.get(ev, 0) + 1
                if ev == "submit" and not detail(job_id):
                    submits[job_id] = None
                    continue
                if ev not in ("submit", "start"):
                    continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                torn += 1
                continue
            job = rec.get("job")
            if head is None:
                ev = rec.get("ev", "")
                counts[ev] = counts.get(ev, 0) + 1
            if job is None:
                continue
            if ev == "submit":
                submits[job["job_id"]] = _submit_fields(job)
            elif ev == "start":
                starts[job["job_id"]] = (job["start_time"],
                                         tuple(job["node_ids"]))
    return {"submit": submits, "start": starts, "counts": counts,
            "torn": torn}
