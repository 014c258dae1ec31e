"""forward_ms.train: the device time of the replicas' forward passes
(the program's ``hwa.step.forward`` spans, the K replicas summed) a
traced inner step."""
from hwabench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "hwa.step.forward", "steps")
