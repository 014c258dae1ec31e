"""sync_ms.train: the mean device time of one ``core.hwa.hwa_sync`` call
(the packing, the fused sync kernel, the replicas' restart and W̿'s
unpack) over the window, from the CUDA events around each call."""


def read(ctx):
    ms = ctx["spans"].get("sync")
    return sum(ms) / len(ms) if ms else None
