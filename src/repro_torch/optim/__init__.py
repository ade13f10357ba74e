"""AdamW, the LR schedule and gradient compression with error feedback
(counterpart of `repro.optim`)."""
from repro_torch.optim.adamw import OptState, adamw_update, global_norm, init_opt_state
from repro_torch.optim.compression import (
    compress_grads,
    decompress_grads,
    init_error_feedback,
)
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["OptState", "adamw_update", "global_norm", "init_opt_state", "warmup_cosine",
           "compress_grads", "decompress_grads", "init_error_feedback"]
