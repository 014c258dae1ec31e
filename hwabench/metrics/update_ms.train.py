"""update_ms.train: the device time of the replicas' SGD updates and the
write-back into the stacked state (the program's ``hwa.step.update``
spans, the K replicas summed) a traced inner step."""
from hwabench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "hwa.step.update", "steps")
