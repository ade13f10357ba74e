"""Fault tolerance of the training loop (counterpart of `repro.runtime`):
the supervisor, the straggler monitor and the elastic re-mesh."""
from repro_torch.runtime.elastic import rebalance_grad_accum, reshard_state, shrink_mesh
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.supervisor import FailureInjector, SimulatedFailure, Supervisor

__all__ = ["FailureInjector", "SimulatedFailure", "StragglerMonitor", "Supervisor",
           "rebalance_grad_accum", "reshard_state", "shrink_mesh"]
