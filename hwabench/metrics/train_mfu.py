"""train_mfu: the whole training step's share of the card's bf16 peak
over the traced slice of the window (whole cycles of H steps and a
sync): 6 * N * tokens / slice / 989 TFLOP/s, N the parameters a token's
products touch (``yardstick.train_matmul_param_count``); the remat
forward's products are not counted."""
from hwabench import yardstick


def read(ctx):
    t, tr = ctx.get("trace"), ctx["traffic"]
    steps = ctx["window"]["traced"]["steps"]
    if not t or not steps:
        return None
    tokens = steps * tr["K"] * tr["batch"] * tr["seq"]
    n = yardstick.train_matmul_param_count(ctx["sizes"])
    return 100.0 * 6 * n * tokens / t["window_s"] / yardstick.PEAK_FLOPS_BF16
