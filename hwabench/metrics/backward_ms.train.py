"""backward_ms.train: the device time of the replicas' backward passes,
the remat recompute included (the program's ``hwa.step.backward``
spans, the K replicas summed) a traced inner step."""
from hwabench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "hwa.step.backward", "steps")
