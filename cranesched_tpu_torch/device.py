"""Device selection shared by every entry point of the port, and the
runner of the per-step loops that replay a step's launches on the card
(``run_steps``).

The port runs on the card.  An entry point given no ``device`` takes
``torch.device("cuda")`` and raises when the process sees no CUDA device;
it never continues quietly on the CPU.  Callers that want the CPU (the
tests, the plain reference runs) say so with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the card; pass "
            "device='cpu' to run it on the CPU")
    return dev


def same_device(a, b) -> bool:
    """``cuda`` and ``cuda:0`` are one device (an unindexed CUDA device
    is the current one, 0 in a process that never changes it)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    return a.type != "cuda" or (a.index or 0) == (b.index or 0)


def run_steps(body, times: int, devices) -> None:
    """Call ``body`` ``times`` times: a per-step loop whose step reads its
    own index from a device tensor and advances it.  Where every device
    is one card, the first call runs as it is (on a side stream, as a
    capture needs) and the rest are replays of its launches recorded once
    in a CUDA graph: one call from the host a step instead of one a
    launch.  Elsewhere (the CPU, several cards) each step is called."""
    devices = [torch.device(d) for d in devices]
    dev = devices[0]
    if dev.type != "cuda" or times < 2 or not all(
            same_device(dev, d) for d in devices):
        for _ in range(times):
            body()
        return
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()                  # recorded, not run
    for _ in range(times - 1):
        graph.replay()
