"""moe_combine_ms.train: the device time of the expert layers' combine
(the routing-weight scale, the inverse permutation and the f32 adds:
the program's ``moe.combine`` spans, forward and remat recompute, every
layer and replica) a traced inner step."""
from hwabench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "moe.combine", "steps")
