"""sync_restart_ms.train: the device time of unpacking W̄ and W̿ and
restarting every replica from W̄ (the program's two ``hwa.sync.restart``
spans a sync, summed) a traced sync."""
from hwabench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "hwa.sync.restart", "syncs")
