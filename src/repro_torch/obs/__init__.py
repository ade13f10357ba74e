"""Cost-model constants of the port (counterpart of the part of `repro.obs`
the planner reads)."""
