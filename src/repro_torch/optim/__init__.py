from repro_torch.optim.adam import adam, adamw, scale_by_adam, sgd
from repro_torch.optim.base import GradientTransformation, apply_updates
from repro_torch.optim.schedules import (
    constant_schedule,
    inverse_sqrt_schedule,
    linear_decay,
    linear_warmup_cosine_decay,
)
