"""flash_fwd_roofline.train: the least time of the traced flash forward
launches (``csrc/flash_fwd.cu``, the forward and the remat forward of
every attention layer of every replica) over their device time: each
launch a causal attention of one replica's batch."""
from hwabench import yardstick
from hwabench.metrics._kernels import kernel_time

KERNEL = "flash_fwd_bf16_kernel"


def read(ctx):
    if not ctx.get("trace"):
        return None
    n, secs = kernel_time(ctx, KERNEL)
    if not n:
        return None
    s, tr = ctx["sizes"], ctx["traffic"]
    flops, nbytes = yardstick.flash_fwd_cost(tr["batch"], tr["seq"], s["H"],
                                             s["Kv"], s["P"])
    return 100.0 * n * yardstick.least_seconds(flops, nbytes) / secs
