from repro_torch.checkpoint.io import (load_pytree, load_window_state,
                                       save_pytree, save_window_state)
from repro_torch.checkpoint.store import OuterWeightStore
