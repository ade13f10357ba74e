"""Fault tolerance of the training loop (counterpart of `repro.runtime`;
the elastic re-mesh is not ported: the port has no mesh)."""
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.supervisor import FailureInjector, SimulatedFailure, Supervisor

__all__ = ["FailureInjector", "SimulatedFailure", "StragglerMonitor", "Supervisor"]
