"""sync_pack_ms.train: the device time of packing the K replicas into the
(K, P) buffer the fused sync kernel reads (the program's
``hwa.sync.pack`` span) a traced sync."""
from hwabench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "hwa.sync.pack", "syncs")
