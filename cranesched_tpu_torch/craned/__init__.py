from cranesched_tpu_torch.craned.sim import SimCluster, SimCraned

__all__ = ["SimCluster", "SimCraned"]
