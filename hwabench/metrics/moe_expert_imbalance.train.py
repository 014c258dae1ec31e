"""moe_expert_imbalance.train: the largest expert group over the mean
group, each summed over the expert layer calls of the traced slice (the
program's counter ``moe.expert_pairs``); 1 is an even split."""
from hwabench.metrics._spans import counter


def read(ctx):
    c = counter(ctx, "moe.expert_pairs")
    return c[0] / c[1] if c and c[1] else None
