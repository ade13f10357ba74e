"""Data-parallel layout of the port (counterpart of `repro.parallel`): the
device `Mesh`, the 1-D "data" mesh and the logical-axis rules."""
from repro_torch.parallel.api import (
    DEFAULT_RULES,
    Mesh,
    axes_leaves,
    axis_rules,
    current_mesh,
    data_mesh,
    is_axes_leaf,
    local_devices,
    logical_spec,
)

__all__ = ["DEFAULT_RULES", "Mesh", "axes_leaves", "axis_rules", "current_mesh",
           "data_mesh", "is_axes_leaf", "local_devices", "logical_spec"]
