"""sync_divergence_ms.train: the device time of the replicas' divergence
from their mean at a sync (the program's ``hwa.sync.divergence`` span)
a traced sync."""
from hwabench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "hwa.sync.divergence", "syncs")
