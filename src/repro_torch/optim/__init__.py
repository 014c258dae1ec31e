from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.optim.sgd import sgd
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedules import cosine_schedule, step_decay_schedule
