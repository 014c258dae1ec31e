"""update_idle_ms.train: the device idle a traced inner step put down
to the program's ``hwa.step.update`` spans: the eager optimizer's
launches."""
from hwabench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "hwa.step.update")
