from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.optim.sgd import sgd
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedules import (constant_schedule, cosine_schedule,
                                         cyclic_schedule,
                                         step_decay_schedule,
                                         swa_constant_schedule,
                                         warmup_cosine_schedule)
