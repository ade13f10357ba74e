"""AdamW and the LR schedule (counterpart of `repro.optim`; gradient
compression is not ported yet)."""
from repro_torch.optim.adamw import OptState, adamw_update, global_norm, init_opt_state
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["OptState", "adamw_update", "global_norm", "init_opt_state", "warmup_cosine"]
