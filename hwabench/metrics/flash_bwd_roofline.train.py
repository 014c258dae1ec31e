"""flash_bwd_roofline.train: the least time of the traced backward
sweeps (``csrc/flash_bwd.cu``: the dq and the dk/dv kernels) over their
device time, each launch at one replica's batch."""
from hwabench import yardstick
from hwabench.metrics._kernels import kernel_time

KERNELS = ("flash_dq_bf16_kernel", "flash_dkv_bf16_kernel")


def read(ctx):
    if not ctx.get("trace"):
        return None
    s, tr = ctx["sizes"], ctx["traffic"]
    costs = yardstick.flash_bwd_cost(tr["batch"], tr["seq"], s["H"],
                                     s["Kv"], s["P"])
    least = secs = 0.0
    for name, (flops, nbytes) in zip(KERNELS, costs):
        n, t = kernel_time(ctx, name)
        least += n * yardstick.least_seconds(flops, nbytes)
        secs += t
    return 100.0 * least / secs if secs else None
