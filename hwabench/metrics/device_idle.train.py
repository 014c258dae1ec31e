"""device_idle.train: the share of the traced slice in which no
operation ran on the device (1 - the union of their intervals /
the slice)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
