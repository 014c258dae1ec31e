"""wa_sync_roofline.train: the least time of the traced fused sync
launches (``csrc/wa_update.cu`` ``wa_sync_fused_kernel``) over their
device time: the K replicas, the ring slot and the total read, three
buffers written, over every parameter of the model."""
import math

from hwabench import yardstick
from hwabench.metrics._kernels import kernel_time

KERNEL = "wa_sync_fused_kernel"


def read(ctx):
    if not ctx.get("trace"):
        return None
    n, secs = kernel_time(ctx, KERNEL)
    if not n:
        return None
    P = sum(math.prod(shape) for shape in ctx["param_shapes"])
    flops, nbytes = yardstick.wa_sync_cost(ctx["traffic"]["K"], P)
    return 100.0 * n * yardstick.least_seconds(
        flops, nbytes, yardstick.PEAK_FLOPS_F32) / secs
