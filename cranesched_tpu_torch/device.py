"""Device selection shared by every entry point of the port.

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
