"""forward_idle_ms.train: the device idle a traced inner step put down
to the program's ``hwa.step.forward`` spans (and the spans under them):
the gaps between the traced kernels at whose middle the forward was the
innermost phase the host was in."""
from hwabench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "hwa.step.forward")
