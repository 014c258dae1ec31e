"""backward_idle_ms.train: the device idle a traced inner step put down
to the program's ``hwa.step.backward`` spans and the spans under them
(the remat recompute's)."""
from hwabench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "hwa.step.backward")
