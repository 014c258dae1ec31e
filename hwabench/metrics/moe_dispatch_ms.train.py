"""moe_dispatch_ms.train: the device time of the expert layers' dispatch
(routing, the sorts, the group sizes and the sorted gather: the
program's ``moe.dispatch`` spans, forward and remat recompute, every
layer and replica) a traced inner step."""
from hwabench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "moe.dispatch", "steps")
