"""Per-daemon logging: rotating files + console.

The reference runs spdlog async rotating-file loggers per daemon with
configured levels and sizes (reference: Utilities/PublicHeader/include/
crane/Logger.h; config.yaml:28-45 — CranedDebugLevel,
CranedLogFile...).  The stdlib equivalent: one root handler pair
(rotating file + stderr) configured at daemon startup; modules log
through ``logging.getLogger(__name__)`` as usual.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def setup_logging(daemon: str, log_file: str = "",
                  level: str = "info", max_mb: int = 32,
                  backups: int = 5) -> logging.Logger:
    """Configure the process-wide logging tree for one daemon.

    ``log_file`` empty = console only (sims, tests, foreground runs).
    Returns the daemon's own logger."""
    root = logging.getLogger("cranesched_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False
    for handler in list(root.handlers):
        root.removeHandler(handler)
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(FORMAT))
    root.addHandler(console)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        rotating = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=max_mb << 20, backupCount=backups)
        rotating.setFormatter(logging.Formatter(FORMAT))
        root.addHandler(rotating)
    return logging.getLogger(f"cranesched_tpu_torch.{daemon}")
