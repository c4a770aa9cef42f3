from repro_torch.optim.optimizers import (
    Optimizer,
    Schedule,
    adam,
    adamw,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
    momentum,
    sgd,
    state_nbytes,
)

__all__ = [
    "Optimizer",
    "Schedule",
    "adam",
    "adamw",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
    "momentum",
    "sgd",
    "state_nbytes",
]
