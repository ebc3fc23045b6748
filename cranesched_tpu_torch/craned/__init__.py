"""Node plane of the port (``cranesched_tpu/craned/``).

``sim`` provides in-process simulated craneds with a virtual clock.
``daemon`` is the real craned (registration FSM, supervisor processes,
cgroups); ``supervisor`` is the per-step process.  Imports are lazy so
that neither a craned nor a supervisor loads the scheduler, and with it
torch.
"""

__all__ = ["SimCluster", "SimCraned", "CranedDaemon", "CranedState"]


def __getattr__(name):
    if name in ("SimCluster", "SimCraned"):
        from cranesched_tpu_torch.craned import sim
        return getattr(sim, name)
    if name in ("CranedDaemon", "CranedState"):
        from cranesched_tpu_torch.craned import daemon
        return getattr(daemon, name)
    raise AttributeError(name)
